"""The port's CUDA kernel on the card: ``bilinear_gather_2d`` against its
plain PyTorch version, alone and inside the render path.

Every test here is marked ``gpu`` and skips where there is no CUDA device.
The file imports neither JAX nor `ngf_tpu`, so it runs on a GPU machine
without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: float32 1e-5 (the same four float32 products summed in another
order); bfloat16 one unit in the last place, at most 2^-7 of the value, since
both round one float32 sum; rendered outputs 1e-4.
"""

import dataclasses
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ngf_tpu_torch.fields import triplane as tt  # noqa: E402
from ngf_tpu_torch.ops import cuda_kernels  # noqa: E402
from ngf_tpu_torch.ops import grid_sample as gs  # noqa: E402
from ngf_tpu_torch.render import volume as tv  # noqa: E402

F32_TOL = 1e-5
RENDER_TOL = 1e-4

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernel runs only on the card")
    return torch.device("cuda")


def test_build_from_source(cuda):
    assert cuda_kernels.build_all() >= 0.0
    assert any(cuda_kernels.BUILD_DIR.glob("libbilinear_gather-*.so"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [slice(0, 24), slice(24, 96), slice(0, 2)])
def test_kernel_matches_plain(cuda, dtype, channels):
    g = torch.Generator(device=cuda).manual_seed(0)
    plane = torch.randn((64, 48, 96), generator=g, device=cuda).to(dtype)
    coords = (torch.rand((5000, 2), generator=g, device=cuda) * 2 - 1) * 1.1
    coords[:2] = torch.tensor([[-1.0, -1.0], [1.0, 1.0]], device=cuda)
    view = plane[..., channels]
    before = cuda_kernels.bilinear_gather_2d.launches
    got = gs.grid_sample_2d(view, coords)
    assert cuda_kernels.bilinear_gather_2d.launches == before + 1
    assert got.dtype == dtype and got.shape == (5000, view.shape[-1])
    want = gs.grid_sample_2d_plain(view, coords)
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= F32_TOL
    else:
        assert bool((err <= 2.0 ** -7 * want.float().abs() + 1e-6).all())
    assert torch.equal(got[0], view[0, 0]) and torch.equal(got[1], view[-1, -1])


def test_strided_coords_and_batch_shape(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    plane = torch.randn((16, 20, 8), generator=g, device=cuda)
    xyz = torch.rand((3, 70, 3), generator=g, device=cuda) * 2 - 1
    for view in (xyz[..., 0:2], xyz[..., 1:3], xyz[..., 0::2]):
        got = gs.grid_sample_2d(plane, view)
        assert got.shape == (3, 70, 8)
        assert (got - gs.grid_sample_2d_plain(plane, view)).abs().max().item() <= F32_TOL


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    coords = torch.zeros((4, 2), device=cuda)
    with pytest.raises(ValueError):
        cuda_kernels.bilinear_gather_2d(torch.zeros((1, 4, 3), device=cuda), coords)
    with pytest.raises(ValueError):
        cuda_kernels.bilinear_gather_2d(torch.zeros((4, 4, 3), device=cuda, dtype=torch.float16), coords)
    with pytest.raises(ValueError):
        cuda_kernels.bilinear_gather_2d(torch.zeros((4, 4, 3), device=cuda).transpose(0, 1), coords)
    with pytest.raises(ValueError):
        cuda_kernels.bilinear_gather_2d(torch.zeros((4, 4, 3), device=cuda), coords.double())
    with pytest.raises(ValueError):
        cuda_kernels.bilinear_gather_2d(torch.zeros((4, 4, 3), device=cuda), coords.cpu())


def test_render_path_goes_through_kernel(cuda):
    cfg = dataclasses.replace(tt.TriPlaneConfig.infoinv_preset(True), plane_res=32)
    params = tt.init_triplane(cfg, torch.Generator(device=cuda).manual_seed(2), cuda)
    params["density_decoder"]["mlp"]["layers"][-1]["b"].fill_(5.5)
    rcfg = tv.RenderConfig(aabb=((-1.5,) * 3, (1.5,) * 3), n_samples=60, step_size=0.09)
    g = torch.Generator(device=cuda).manual_seed(3)
    d = torch.randn((256, 3), generator=g, device=cuda)
    d = d / d.norm(dim=-1, keepdim=True)
    rays = torch.cat([-3.5 * d + 0.3 * torch.randn((256, 3), generator=g, device=cuda), d], -1)
    before = cuda_kernels.bilinear_gather_2d.launches
    got = tv.render_rays(params, cfg, rcfg, rays)
    assert cuda_kernels.bilinear_gather_2d.launches == before + 6
    plain = tv.render_rays(params, cfg, rcfg, rays,
                           sample_fn=lambda p, c, name: gs.grid_sample_2d_plain(p, c))
    assert 0.02 < got["acc_map"].mean().item() < 0.98
    for k in got:
        assert (got[k] - plain[k]).abs().max().item() <= RENDER_TOL, k
