"""The port's CUDA kernels on the card against their plain PyTorch
versions: ``bilinear_gather_2d`` alone and inside the render path, its
backward ``bilinear_gather_2d_backward`` alone (runs of shared stencils,
zero rows, both lane widths, strided g) and through autograd, and
``gather_rows``, alone and as the trainer's one-launch batch.

Every test here is marked ``gpu`` and skips where there is no CUDA device.
The file imports neither JAX nor `ngf_tpu`, so it runs on a GPU machine
without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: float32 1e-5 (the same four float32 products summed in another
order); bfloat16 one unit in the last place, at most 2^-7 of the value, since
both round one float32 sum; rendered outputs 1e-4; plane gradients 1e-5 of
the largest gradient (float32 atomics add in another order); row gathers
exactly.
"""

import dataclasses
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ngf_tpu_torch.fields import triplane as tt  # noqa: E402
from ngf_tpu_torch.ops import cuda_kernels, gather  # noqa: E402
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
    for name in ("bilinear_gather", "bilinear_gather_backward", "gather_rows"):
        assert any(cuda_kernels.BUILD_DIR.glob(f"lib{name}-*.so")), name


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


def _ray_coords(g, cuda, n_rays=64, m=80, res=64):
    """Ray-consecutive coordinates half a texel apart (the atomics of the
    backward then meet on shared texels), some leaving [-1, 1]."""
    start = torch.rand((n_rays, 1, 2), generator=g, device=cuda) * 2.2 - 1.1
    d = torch.randn((n_rays, 1, 2), generator=g, device=cuda)
    d = d / d.abs().amax(-1, keepdim=True)
    t = torch.arange(m, device=cuda, dtype=torch.float32)[None, :, None]
    return start + d * t * (1.0 / (res - 1))


@pytest.mark.parametrize("channels", [slice(0, 24), slice(24, 96)])
def test_backward_kernel_matches_plain(cuda, channels):
    """The kernel adds into its channels of a prefilled whole-plane
    gradient, as the plain version does. Tolerance 1e-5 of the largest
    gradient: float32 atomics sum each texel's terms in another order."""
    g = torch.Generator(device=cuda).manual_seed(4)
    coords = _ray_coords(g, cuda)
    coords[0, :2] = torch.tensor([[-1.0, -1.0], [1.0, 1.0]], device=cuda)
    C = channels.stop - channels.start
    grad_out = torch.randn((*coords.shape[:-1], C), generator=g, device=cuda)
    prefill = torch.randn((64, 64, 96), generator=g, device=cuda)
    got, want = prefill.clone(), prefill.clone()
    before = cuda_kernels.bilinear_gather_2d_backward.launches
    cuda_kernels.bilinear_gather_2d_backward(grad_out, coords, got, channels.start)
    assert cuda_kernels.bilinear_gather_2d_backward.launches == before + 1
    gs.grid_sample_2d_backward_plain(grad_out, coords, want, channels.start)
    tol = 1e-5 * (want - prefill).abs().max().item()
    assert (got - want).abs().max().item() <= tol
    outside = torch.ones(96, dtype=torch.bool)
    outside[channels] = False
    assert torch.equal(got[..., outside], prefill[..., outside])


def _k2_inputs(case, g, cuda):
    """(coords (N, 2), cotangent (N, C), channel offset) of a backward case.
    The vector kernel owns tiles of 224 points for C = 72 and 672 for
    C = 24, in segments of 16. Ray-consecutive points half a texel apart
    step by one texel along x (or y, or both) or not at all."""
    n, C, c0 = 5000, 72, 24
    coords = _ray_coords(g, cuda).reshape(-1, 2)[:n]
    if case == "runs_across_tiles":
        # Points 400..499 in one texel: a run across segment ends and the
        # tile end at 448.
        coords[400:500] = 0.31 + 1e-3 * torch.rand((100, 2), generator=g, device=cuda)
    elif case == "run_spans_a_tile":
        coords[:1100] = -0.52 + 1e-3 * torch.rand((1100, 2), generator=g, device=cuda)
    elif case == "outside":
        coords = torch.rand((n, 2), generator=g, device=cuda) * 3.0 - 1.5
    elif case == "scalar_lanes":
        C, c0 = 10, 3
    elif case == "density_offset_0":
        C, c0 = 24, 0
    elif case == "density_run_spans_a_tile":
        C, c0 = 24, 0
        coords[:1100] = 0.77 + 1e-3 * torch.rand((1100, 2), generator=g, device=cuda)
    elif case == "ragged_n":
        n = 1001
        coords = coords[:n]
    grad_out = torch.randn((n, C), generator=g, device=cuda)
    if case == "zero_rows":
        grad_out[torch.rand(n, generator=g, device=cuda) < 0.9] = 0.0
    elif case == "strided_g_aligned":
        grad_out = torch.randn((n, 100), generator=g, device=cuda)[:, 8 : 8 + C]
    elif case == "strided_g_unaligned":
        grad_out = torch.randn((n, 100), generator=g, device=cuda)[:, 1 : 1 + C]
    return coords, grad_out, c0


@pytest.mark.parametrize("case", [
    "runs_across_tiles", "run_spans_a_tile", "zero_rows", "outside", "scalar_lanes",
    "density_offset_0", "ragged_n", "strided_g_aligned", "strided_g_unaligned",
    "density_run_spans_a_tile",
])
def test_backward_kernel_cases(cuda, case):
    """The run-merged scatter against its plain version, 1e-5 of the
    largest gradient, into a prefilled stride-96 buffer; channels outside
    the fetch stay as they were."""
    g = torch.Generator(device=cuda).manual_seed(8)
    coords, grad_out, c0 = _k2_inputs(case, g, cuda)
    C = grad_out.shape[-1]
    prefill = torch.randn((64, 64, 96), generator=g, device=cuda)
    got, want = prefill.clone(), prefill.clone()
    before = cuda_kernels.bilinear_gather_2d_backward.launches
    cuda_kernels.bilinear_gather_2d_backward(grad_out, coords, got, c0)
    assert cuda_kernels.bilinear_gather_2d_backward.launches == before + 1
    gs.grid_sample_2d_backward_plain(grad_out, coords, want, c0)
    tol = 1e-5 * (want - prefill).abs().max().item()
    assert tol > 0 and (got - want).abs().max().item() <= tol
    outside = torch.ones(96, dtype=torch.bool)
    outside[c0 : c0 + C] = False
    assert torch.equal(got[..., outside], prefill[..., outside])


@pytest.mark.parametrize("c0,C", [(24, 72), (0, 24), (3, 10)])
def test_backward_kernel_zero_cotangent_leaves_the_buffer(cuda, c0, C):
    """All-zero rows make no atomic: the buffer keeps its exact bits, -0.0
    included (adding +0.0 would turn -0.0 into +0.0)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    coords = _ray_coords(g, cuda)
    buf = torch.randn((64, 64, 96), generator=g, device=cuda)
    buf[::2] = -0.0
    got = buf.clone()
    cuda_kernels.bilinear_gather_2d_backward(
        torch.zeros((*coords.shape[:-1], C), device=cuda), coords, got, c0)
    assert torch.equal(got.view(torch.int32), buf.view(torch.int32))


def test_batch_is_one_row_gather(cuda):
    """The trainer's batch is one ``gather_rows`` launch of its (N, 9) table
    at ids already on the card, equal to ``all_rays[ids]`` and
    ``all_rgbs[ids]`` of the numpy sampler's ids; one id upload per epoch."""
    from ngf_tpu_torch.config import TrainArgs
    from ngf_tpu_torch.data import load_dataset
    from ngf_tpu_torch.data.sampler import SimpleSampler
    from ngf_tpu_torch.train.loop import TriPlaneTrainer

    datadir = "synthetic:views=2,wh=16,test_views=1"
    args = TrainArgs(dataset_name="synthetic", datadir=datadir, plane_res=32, nSamples=48,
                     step_ratio=1.0, batch_size=96, n_iters=12, group_size=0, device="cuda")
    ds = load_dataset("synthetic", datadir, split="train", is_stack=False)
    trainer = TriPlaneTrainer(args, ds, device=cuda)
    total = trainer.batch_table.shape[0]
    ref = SimpleSampler(total, 96, args.seed)
    for _ in range(12):
        before = cuda_kernels.gather_rows.launches
        rays, rgbs = trainer.next_batch()
        assert cuda_kernels.gather_rows.launches == before + 1
        ids = torch.from_numpy(ref.nextids()).to(cuda)
        assert torch.equal(rays, trainer.all_rays[ids]) and torch.equal(rgbs, trainer.all_rgbs[ids])
    assert trainer.sampler.uploads == -(-12 // (total // 96))


def test_autograd_plane_gradient_through_kernels(cuda):
    """Density and appearance fetches of one shared plane: forward and
    backward kernels launch once per fetch, and the plane gradient equals
    the plain versions' on the CPU."""
    g = torch.Generator(device=cuda).manual_seed(5)
    plane = torch.randn((64, 64, 96), generator=g, device=cuda)
    coords = _ray_coords(g, cuda)
    weights = torch.randn((*coords.shape[:-1], 96), generator=g, device=cuda)

    def plane_grad(p0, c, w):
        p = p0.clone().requires_grad_(True)
        shared = gs.share_plane_grad(p)
        loss = sum((gs.grid_sample_2d(shared, c, ch) * w[..., ch]).sum()
                   for ch in (slice(0, 24), slice(24, 96)))
        loss.backward()
        return p.grad

    counts = (cuda_kernels.bilinear_gather_2d.launches,
              cuda_kernels.bilinear_gather_2d_backward.launches)
    got = plane_grad(plane, coords, weights)
    assert cuda_kernels.bilinear_gather_2d.launches == counts[0] + 2
    assert cuda_kernels.bilinear_gather_2d_backward.launches == counts[1] + 2
    want = plane_grad(plane.cpu(), coords.cpu(), weights.cpu())
    assert (got.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_coordinate_gradient_on_the_card_raises(cuda):
    plane = torch.zeros((4, 4, 3), device=cuda, requires_grad=True)
    coords = torch.zeros((5, 2), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gs.grid_sample_2d(plane, coords)


@pytest.mark.parametrize("index_dtype", [torch.int64, torch.int32])
def test_gather_rows_matches_plain(cuda, index_dtype):
    """The probes' own shapes (`tools/probe_pallas.py:29-36`) and the
    trainer's row widths; an index out of range gives a NaN row."""
    tab = torch.arange(512 * 128, dtype=torch.float32, device=cuda).reshape(512, 128)
    idx = (torch.arange(256, device=cuda) * 7 % 512).to(index_dtype)
    before = cuda_kernels.gather_rows.launches
    assert torch.equal(gather.gather_rows(tab, idx), gather.gather_rows_plain(tab, idx))
    assert cuda_kernels.gather_rows.launches == before + 1
    g = torch.Generator(device=cuda).manual_seed(6)
    for d in (6, 3):
        tab = torch.randn((1000, d), generator=g, device=cuda)
        idx = torch.randint(0, 1000, (300,), generator=g, device=cuda).to(index_dtype)
        assert torch.equal(gather.gather_rows(tab, idx), tab[idx])
    bad = torch.tensor([0, 1000, -1], device=cuda).to(index_dtype)
    out = cuda_kernels.gather_rows(tab, bad)
    assert torch.equal(out[0], tab[0]) and bool(out[1:].isnan().all())


def test_gather_rows_refuses_what_the_kernel_does_not_take(cuda):
    tab = torch.zeros((8, 6), device=cuda)
    idx = torch.zeros((4,), dtype=torch.int64, device=cuda)
    for t, i in ((tab.double(), idx), (tab.t(), idx), (tab, idx.float()), (tab, idx.cpu()),
                 (tab[None], idx), (tab, idx[None])):
        with pytest.raises(ValueError):
            cuda_kernels.gather_rows(t, i)


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
