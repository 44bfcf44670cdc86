"""The port's CUDA kernels on the card against their plain PyTorch
versions: the gather ``bilinear_gather_planes`` (three planes, split
outputs, both lane widths, runs of shared stencils) and its one-plane call
``bilinear_gather_2d``, alone and inside the render path (one launch per
chunk), its backward ``bilinear_gather_2d_backward`` alone (runs of shared
stencils, zero rows, both lane widths, strided g) and through autograd, and
``gather_rows``, alone and as the trainer's one-launch batch; the occupancy
lookup ``occupancy_lookup`` (K3, its contiguous and strided paths) and the
grouped front end ``group_sample_compact`` (K4: sampling, occupancy test and
compaction) alone, refusing CPU tensors, and inside the render paths;
the gather over planes of three shapes (the learned gauge after its shrink
and upsample), and K2c ``bilinear_gather_planes_backward_coords`` (the plane
and coordinate gradients of a fetch of 1 to 3 planes in one launch) alone,
its footprint (three blocks an SM), through autograd and in a gauge train
step; K2 and K2c on bfloat16 cotangents and planes (both lane widths,
aligned and unaligned strides, the gauge's three shapes), their footprint,
the bfloat16 fetch through autograd, a bfloat16 gauge train step and the
bfloat16 decoder layer's float32 product; K5 ``ray_march`` and
``ray_march_backward`` (the NeuTex compositing scan and its reverse scan) at
the UV path's shapes, with alpha rounding to 1, strided inputs, without
colour, and through ``march_rays``'s autograd one cotangent at a time; K5's
tri-plane mode ``ray_march_triplane`` and its backward against
``composite_plain`` and ``composite_backward_plain`` (dense and grouped
lengths, the three backgrounds, alpha 1, empty rays, strided inputs, a
render chunk's 884 samples), the threshold mask the same bit for bit in
both directions, its refusals, and the dense and grouped renders
compositing in one launch each way with no ``cumprod``; K5's tri-plane
shard mode (``ray_march_triplane_totals``, ``ray_march_triplane_shard`` and
``ray_march_triplane_shard_backward``) against its plain versions at the
sample-parallel path's shapes (884 samples over 2 and 4 shards), with t0
random in (0, 1] and t0 = 0 behind opaque runs, the split identity (two
chained shard launches against one whole-ray launch, to 1e-6, the mask
equal) and ``composite_shard``'s three launches through autograd; K5's
top-K mode (the weight launch without colour, ``ray_march_triplane_topk``
and its backward, and the weight backward with the cotangent of w) against
``composite_topk_plain``, ``composite_topk_backward_plain`` and
``composite_backward_plain`` (dense and grouped picks, the backgrounds,
alpha 1, empty rays, strided colours), its refusals and footprint, and the
dense and grouped top-K training renders (their launches, no ``cumprod``,
against the CPU), the packed grouped training render (its row gathers and
scatters, against the CPU); ``gather_rows`` on bfloat16 rows and with ids relative
to segments, in and out of their segment, and its backward
``scatter_rows``, byte for byte, on 16-byte and narrow words, aligned and
unaligned tables, both scatter routes, and the group gather through
autograd, with the row kernels' footprint; LPIPS on the card against its CPU forward,
the mesh export's alpha chunk (one K1 launch, against the CPU; 32 launches
an export at 256^3) and the UV ray functions on CUDA tensors against CPU
ones.

Every test here is marked ``gpu`` and skips where there is no CUDA device.
The file imports neither JAX nor `ngf_tpu`, so it runs on a GPU machine
without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: float32 1e-5 (the same four float32 products summed in another
order); bfloat16 one unit in the last place, at most 2^-7 of the value, since
both round one float32 sum; rendered outputs 1e-4; plane gradients 1e-5 of
the largest gradient (float32 atomics add in another order), and so the
coordinate gradients (their tap sums run over the channels in another
order), from bfloat16 cotangents and planes too, and K5's outputs and gradients
(the same float32 scan; the plain version's cumprod and sums round in
another order) (kernel and plain version
widen the same bfloat16 values and sum in float32); a bfloat16 train step
against the plain sampler 3e-2 of each leaf's largest gradient (see the
test); row gathers,
occupancy lookups and the grouped front end byte for byte (a NaN output
against a NaN, whatever its payload).
"""

import dataclasses
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ngf_tpu_torch.fields import triplane as tt  # noqa: E402
from ngf_tpu_torch.ops import compaction, cuda_kernels, gather  # noqa: E402
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
    for name in ("bilinear_gather", "bilinear_gather_backward", "gather_rows",
                 "occupancy_lookup", "group_compact", "ray_march"):
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
    """A split fetch of three planes: one forward launch, and the backward
    kernel once per plane and output (6), each plane's gradient equal to
    the plain versions' on the CPU."""
    g = torch.Generator(device=cuda).manual_seed(5)
    planes = [torch.randn((64, 64, 96), generator=g, device=cuda) for _ in range(3)]
    coords = [_ray_coords(g, cuda) for _ in range(3)]
    wa = torch.randn((*coords[0].shape[:-1], 3, 24), generator=g, device=cuda)
    wb = torch.randn((*coords[0].shape[:-1], 3, 72), generator=g, device=cuda)

    def plane_grads(ps, cs, a, b):
        ps = [p.clone().requires_grad_(True) for p in ps]
        dens, app = gs.grid_sample_planes(ps, cs, split=24)
        ((dens * a).sum() + (app * b).sum()).backward()
        return [p.grad for p in ps]

    counts = (cuda_kernels.bilinear_gather_planes.launches,
              cuda_kernels.bilinear_gather_2d_backward.launches)
    got = plane_grads(planes, coords, wa, wb)
    assert cuda_kernels.bilinear_gather_planes.launches == counts[0] + 1
    assert cuda_kernels.bilinear_gather_2d_backward.launches == counts[1] + 6
    want = plane_grads([p.cpu() for p in planes], [c.cpu() for c in coords], wa.cpu(), wb.cpu())
    for a, b in zip(got, want):
        assert (a.cpu() - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def _gather_case(case, g, cuda):
    """(planes, coords, channels, split) of a three-plane gather case: the
    projections of ray-consecutive points half a texel apart (runs of equal
    stencil starts and one-texel steps, some leaving [-1, 1]) as strided
    views, N = 5001, not a multiple of any tile."""
    xyz = torch.cat([_ray_coords(g, cuda, m=80).reshape(-1, 2),
                     torch.rand((64 * 80, 1), generator=g, device=cuda) * 2.2 - 1.1], -1)
    xyz = xyz[:5001]
    coords = [xyz[:, 0:2], xyz[:, 1:3], xyz[:, 0::2]]
    C, channels, split = 96, slice(None), 24
    if case == "split_16":
        C, split = 64, 16
    elif case == "no_split":
        split = None
    elif case == "one_plane_c2":
        C, split = 2, None
        coords = coords[:1]
    elif case == "scalar_lanes":
        channels, split = slice(3, 13), 5
    elif case == "random_coords":
        xyz.uniform_(-1.1, 1.1, generator=g)
    elif case == "one_texel_runs":
        # Long runs inside one texel, across segment and tile ends.
        xyz[100:900] = 0.31 + 1e-3 * torch.rand((800, 3), generator=g, device=cuda)
    xyz[:3] = torch.tensor([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0], [-1.0, 1.0, 1.0]], device=cuda)
    planes = [torch.randn((48, 64, C), generator=g, device=cuda) for _ in coords]
    return planes, coords, channels, split


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["split_24", "split_16", "no_split", "one_plane_c2",
                                  "scalar_lanes", "random_coords", "one_texel_runs"])
def test_planes_kernel_matches_plain(cuda, dtype, case):
    """The three-plane gather against its plain version: float32 1e-5,
    bfloat16 one ulp; the corners hit their texels."""
    g = torch.Generator(device=cuda).manual_seed(10)
    planes, coords, channels, split = _gather_case(case, g, cuda)
    planes = [p.to(dtype) for p in planes]
    before = cuda_kernels.bilinear_gather_planes.launches
    got = cuda_kernels.bilinear_gather_planes(planes, coords, channels, split)
    assert cuda_kernels.bilinear_gather_planes.launches == before + 1
    want = gs.grid_sample_planes_plain(planes, coords, channels, split)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == dtype and a.shape == b.shape and a.is_contiguous()
        err = (a.float() - b.float()).abs()
        if dtype == torch.float32:
            assert err.max().item() <= F32_TOL
        else:
            assert bool((err <= 2.0 ** -7 * b.float().abs() + 1e-6).all())
    full = torch.cat([o for o in got if o is not None], -1)
    for i, (plane, c) in enumerate(zip(planes, coords)):
        H, W, _ = plane.shape
        for n in range(3):  # corners: each coordinate -1 or +1
            texel = plane[int(c[n, 1] > 0) * (H - 1), int(c[n, 0] > 0) * (W - 1)]
            assert torch.equal(full[n, i], texel[channels])


def test_planes_lanes_follow_alignment(cuda):
    """16-byte lanes where C, the split, the texel stride and the pointers
    allow them; the scalar branch for an odd channel offset."""
    plane = torch.zeros((4, 4, 96), device=cuda)
    assert cuda_kernels.gather_lanes(torch.float32, 96, 24, [96], [plane.data_ptr()]) == 4
    assert cuda_kernels.gather_lanes(torch.bfloat16, 96, 24, [96], [plane.data_ptr()]) == 8
    assert cuda_kernels.gather_lanes(torch.float32, 10, 5, [96], [plane.data_ptr() + 12]) == 1


def test_planes_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    p = torch.zeros((4, 4, 8), device=cuda)
    c = torch.zeros((5, 2), device=cuda)
    bad = [
        ((), ()),  # no plane
        ((p,) * 4, (c,) * 4),  # four planes
        ((p, p), (c,)),  # coords missing
        ((p, torch.zeros((4, 5, 9), device=cuda)), (c, c)),  # channel counts differ
        ((p, p.bfloat16()), (c, c)),  # dtypes differ
        ((p, p), (c, torch.zeros((6, 2), device=cuda))),  # coords differ
        ((p.cpu(),), (c.cpu(),)),  # not on the card
        ((p.half(),), (c,)),  # float16
        ((p.transpose(0, 1),), (c,)),  # rows not W texels apart
        ((p,), (c.double(),)),
    ]
    for planes, coords in bad:
        with pytest.raises(ValueError):
            cuda_kernels.bilinear_gather_planes(planes, coords)
    for channels, split in ((slice(0, 8, 2), None), (slice(3, 3), None), (slice(None), 0),
                            (slice(None), 8), (slice(0, 4), 5)):
        with pytest.raises(ValueError):
            cuda_kernels.bilinear_gather_planes((p,), (c,), channels, split)


def test_coordinate_gradient_on_the_card_raises(cuda):
    """A float16 plane is not taken: the fetch raises before any launch
    (float32 and bfloat16 planes go through K1, K2 and K2c)."""
    plane = torch.zeros((4, 4, 3), device=cuda, dtype=torch.float16, requires_grad=True)
    coords = torch.zeros((5, 2), device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="bfloat16"):
        gs.grid_sample_2d(plane, coords).float().sum().backward()


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
    before = (cuda_kernels.bilinear_gather_planes.launches,
              cuda_kernels.bilinear_gather_2d.launches)
    got = tv.render_rays(params, cfg, rcfg, rays)
    assert (cuda_kernels.bilinear_gather_planes.launches,
            cuda_kernels.bilinear_gather_2d.launches) == (before[0] + 1, before[1])
    plain = tv.render_rays(params, cfg, rcfg, rays,
                           sample_fn=lambda p, c, name: gs.grid_sample_2d_plain(p, c))
    assert 0.02 < got["acc_map"].mean().item() < 0.98
    for k in got:
        assert (got[k] - plain[k]).abs().max().item() <= RENDER_TOL, k


def _ball(shape, cuda, seed=0):
    """A {0, 1} uint8 ball of radius 0.6 in [-1, 1]^3 with 5% of the voxels
    flipped, dilated by one voxel."""
    axes = [torch.linspace(-1, 1, n, device=cuda) for n in shape]
    z, y, x = torch.meshgrid(*axes, indexing="ij")
    g = torch.Generator(device=cuda).manual_seed(seed)
    vol = (x * x + y * y + z * z < 0.36) ^ (torch.rand(shape, generator=g, device=cuda) < 0.05)
    return (gs.max_pool_3d(vol.float(), 3) > 0).to(torch.uint8)


@pytest.mark.parametrize("shape", [(12, 14, 16), (128, 128, 128)])
def test_occupancy_lookup_matches_plain(cuda, shape):
    """Random points, texel centres and edges, the faces and NaN; and world
    points with a box, read as a strided view."""
    vol = _ball(shape, cuda)
    D, H, W = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    sizes = torch.tensor([W, H, D], device=cuda, dtype=torch.float32)
    lattice = torch.floor(torch.rand((20000, 3), generator=g, device=cuda) * sizes)
    edges = lattice + 0.5 * torch.randint(-1, 2, (20000, 3), generator=g, device=cuda)
    cases = [torch.rand((50000, 3), generator=g, device=cuda) * 2.2 - 1.1,
             lattice * 2.0 / (sizes - 1) - 1.0, edges * 2.0 / (sizes - 1) - 1.0]
    cases[2][:4] = torch.tensor([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [float("nan"), 0.0, 0.0],
                                 [1.0001, 0.0, 0.0]], device=cuda)
    for coords in cases:
        before = cuda_kernels.occupancy_lookup.launches
        got = gs.occupancy_lookup(vol, coords)
        assert cuda_kernels.occupancy_lookup.launches == before + 1
        assert got.dtype == torch.bool
        assert torch.equal(got, gs.occupancy_lookup_plain(vol, coords))
    aabb = torch.tensor([[-1.2, -1.3, -1.1], [1.4, 1.2, 1.3]], device=cuda)
    pts = torch.rand((64, 96, 3), generator=g, device=cuda) * 3.2 - 1.6
    for view in (pts, pts[:, 2::4], pts[5], pts[:, :, None].expand(64, 96, 2, 3)):
        got = gs.occupancy_lookup(vol, view, aabb)
        assert got.shape == view.shape[:-1]
        assert torch.equal(got, gs.occupancy_lookup_plain(vol, view, aabb))
        assert 0.0 < got.float().mean().item() < 1.0


@pytest.mark.parametrize("case", ["filter_chunk", "ragged", "unaligned", "coords"])
def test_occupancy_lookup_contiguous_path(cuda, case):
    """The contiguous path (four points a thread) at a mask event's filter
    chunk, 51,200 rays x 256 points in a 128^3 volume; a point count that
    leaves a tail; a contiguous array that is not 16-byte aligned (the
    strided path); coordinates without a box."""
    vol = _ball((128, 128, 128), cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    aabb = torch.tensor([[-1.2, -1.3, -1.1], [1.4, 1.2, 1.3]], device=cuda)
    if case == "filter_chunk":
        pts = torch.rand((51200, 256, 3), generator=g, device=cuda) * 3.2 - 1.6
    else:
        pts = torch.rand((3 * 1001 + 1,), generator=g, device=cuda) * 3.2 - 1.6
        pts = (pts[1:] if case == "unaligned" else pts[:-1]).view(1001, 3)
        assert pts.is_contiguous()
    if case == "coords":
        aabb = None
    before = cuda_kernels.occupancy_lookup.launches
    got = gs.occupancy_lookup(vol, pts, aabb)
    assert cuda_kernels.occupancy_lookup.launches == before + 1
    assert got.shape == pts.shape[:-1]
    assert torch.equal(got, gs.occupancy_lookup_plain(vol, pts, aabb))
    assert 0.0 < got.float().mean().item() < 1.0


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Byte for byte, a NaN against a NaN whatever its payload."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


def _front_end_rays(cuda, n=1000):
    """n rays as a (n, 9) table's row views (the trainer's batch): from a
    sphere of radius 4 at points of [-1.6, 1.6]^3, so some miss the box; one
    along an axis with two zero direction components, one with one zero
    component that misses, and NaN rays."""
    g = torch.Generator(device=cuda).manual_seed(7)
    o = torch.randn((n, 3), generator=g, device=cuda)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = torch.rand((n, 3), generator=g, device=cuda) * 3.2 - 1.6 - o
    d = d / d.norm(dim=-1, keepdim=True)
    table = torch.zeros((n, 9), device=cuda)
    table[:, :3], table[:, 3:6] = o, d
    table[0, :6] = torch.tensor([0.3, -0.2, 4.0, 0.0, 0.0, -1.0], device=cuda)
    table[1, :6] = torch.tensor([4.0, 4.0, 4.0, 1.0, 0.0, 0.0], device=cuda)
    table[2, :6] = float("nan")
    table[3, 4] = float("nan")
    return table[:, :6]


@pytest.mark.parametrize("with_volume", [False, True], ids=["open", "masked"])
@pytest.mark.parametrize("capg", [1, 16, 64, "all"])
@pytest.mark.parametrize("G", [8, 3])
def test_group_sample_compact_matches_plain(cuda, G, capg, with_volume):
    """The grouped front end at a train step's depth (886 samples, 111
    groups of 8 or 296 of 3), capacities that truncate many rays and none,
    with and without a 128^3 volume and jitter; rays of a strided table, an
    axis ray, a missing ray, NaN rays: every output byte for byte."""
    rays = _front_end_rays(cuda)
    n, S = rays.shape[0], 886
    ng = -(-S // G)
    capg = ng if capg == "all" else capg
    g = torch.Generator(device=cuda).manual_seed(8)
    jitter = torch.rand((n, 1), generator=g, device=cuda) if capg in (16, ng) else None
    aabb = torch.tensor([[-1.5] * 3, [1.5] * 3], device=cuda)
    vol = (_ball((128, 128, 128), cuda), torch.tensor([[-1.2, -1.3, -1.1], [1.4, 1.2, 1.3]],
                                                      device=cuda)) if with_volume else (None, None)
    args = (rays, jitter, aabb, 2.0, 6.0, S, 0.0101, G, capg, *vol)
    before = cuda_kernels.group_sample_compact.launches
    got = compaction.group_sample_compact(*args, indices=True)
    assert cuda_kernels.group_sample_compact.launches == before + 1
    want = compaction.group_sample_compact_plain(*args)
    for a, b, name in zip(got, want, ("idx", "got", "z_c", "vmask", "xyz_n")):
        assert _same_bits(a, b), name
    idx, held, z_c, vmask, xyz_n = got
    assert held[0].any() and not held[1].any() and not held[2:4].any()
    assert bool(z_c[2].isnan().all()) and 0.0 < vmask.mean().item() < 1.0
    if capg <= 16:  # these rays hold at most ~50 valid groups of 8
        assert (held.sum(-1) == capg).any()
    _, _, z2, v2, x2 = compaction.group_sample_compact(*args)  # without idx and got
    assert _same_bits(z2, z_c) and _same_bits(v2, vmask) and _same_bits(x2, xyz_n)


def test_kernels_refuse_cpu_tensors_and_wrong_inputs(cuda):
    """No fallback: the K3 and K4 wrappers raise on a CPU tensor and on
    what their kernels do not take."""
    vol = torch.zeros((4, 4, 4), dtype=torch.uint8, device=cuda)
    pts = torch.zeros((10, 3), device=cuda)
    for v, p, a in ((vol.cpu(), pts, None), (vol, pts.cpu(), None), (vol.float(), pts, None),
                    (vol, pts.double(), None), (vol.transpose(0, 1), pts, None),
                    (vol, pts, torch.zeros((2, 3))), (vol, pts[:, :2], None)):
        with pytest.raises(ValueError):
            cuda_kernels.occupancy_lookup(v, p, a)
    rays = torch.zeros((4, 6), device=cuda)
    box = torch.tensor([[-1.0] * 3, [1.0] * 3], device=cuda)
    ok = dict(rays=rays, jitter=None, aabb=box, volume=None, volume_aabb=None, group=8, capg=2)
    bad = [dict(rays=rays.cpu()), dict(aabb=box.cpu()), dict(rays=rays.double()),
           dict(rays=torch.zeros((4, 5), device=cuda)), dict(rays=rays.t().contiguous().t()),
           dict(jitter=torch.zeros((4,), device=cuda)), dict(jitter=torch.zeros((4, 1))),
           dict(aabb=box[:, :2]), dict(volume=vol, volume_aabb=box[:, :2]),
           dict(volume=vol.float(), volume_aabb=box),
           dict(volume=vol.cpu(), volume_aabb=box), dict(group=33), dict(group=0),
           dict(capg=0), dict(capg=4)]  # 20 samples in groups of 8: at most 3 groups
    for change in bad:
        kw = {**ok, **change}
        with pytest.raises(ValueError):
            cuda_kernels.group_sample_compact(kw["rays"], kw["jitter"], kw["aabb"], 2.0, 6.0,
                                              20, 0.1, kw["group"], kw["capg"], kw["volume"],
                                              kw["volume_aabb"])


def _scene(cuda, seed=2):
    cfg = dataclasses.replace(tt.TriPlaneConfig.infoinv_preset(True), plane_res=32)
    params = tt.init_triplane(cfg, torch.Generator(device=cuda).manual_seed(seed), cuda)
    params["density_decoder"]["mlp"]["layers"][-1]["b"].fill_(5.5)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    d = torch.randn((256, 3), generator=g, device=cuda)
    d = d / d.norm(dim=-1, keepdim=True)
    rays = torch.cat([-3.5 * d + 0.3 * torch.randn((256, 3), generator=g, device=cuda), d], -1)
    return cfg, params, rays


def test_render_only_mask_goes_through_k3(cuda, monkeypatch):
    """The dense path with a checkpoint's float mask: one K3 launch per
    chunk, and the plain lookup never runs."""
    cfg, params, rays = _scene(cuda)
    rcfg = tv.RenderConfig(aabb=((-1.5,) * 3, (1.5,) * 3), n_samples=60, step_size=0.09)
    vol = _ball((16, 16, 16), cuda).float()
    want = tv.render_rays(params, cfg, rcfg, rays, alpha_volume=vol,
                          sample_fn=lambda p, c, name: gs.grid_sample_2d_plain(p, c))
    monkeypatch.setattr(gs, "occupancy_lookup_plain", None)
    before = cuda_kernels.occupancy_lookup.launches
    got = tv.render_rays(params, cfg, rcfg, rays, alpha_volume=vol)
    assert cuda_kernels.occupancy_lookup.launches == before + 1
    for k in got:
        assert (got[k] - want[k]).abs().max().item() <= RENDER_TOL, k


@pytest.mark.parametrize("with_alpha", [False, True], ids=["open", "masked"])
def test_grouped_render_launches_k1_k3_k4_once(cuda, with_alpha):
    """A grouped chunk: one launch each of K1 and K4 (the whole front end,
    the mask's test included) and none of K3; against the plain sampler to
    1e-4."""
    cfg, params, rays = _scene(cuda, seed=4)
    rcfg = tv.RenderConfig(aabb=((-1.5,) * 3, (1.5,) * 3), n_samples=60, step_size=0.09,
                           group_size=8, sample_cap=32, tile_q=0)
    kw = {"alpha_volume": _ball((16, 16, 16), cuda)} if with_alpha else {}
    names = ("bilinear_gather_planes", "occupancy_lookup", "group_sample_compact")
    before = [cuda_kernels.KERNELS[k].launches for k in names]
    got = tv.render_rays(params, cfg, rcfg, rays, **kw)
    after = [cuda_kernels.KERNELS[k].launches for k in names]
    assert [a - b for a, b in zip(after, before)] == [1, 0, 1]
    plain = tv.render_rays(params, cfg, rcfg, rays, **kw,
                           sample_fn=lambda p, c, name: gs.grid_sample_2d_plain(p, c))
    assert 0.02 < got["acc_map"].mean().item() < 0.98
    for k in got:
        assert (got[k] - plain[k]).abs().max().item() <= RENDER_TOL, k


# Plane shapes of the learned gauge: the planes cropped to the occupied box
# (xy (ry, rx), yz (rz, ry), xz (rz, rx)) and resized per axis.
GAUGE_SHAPES = [(37, 45), (51, 37), (51, 45)]


def _gauge_planes(g, cuda, C=64):
    return [torch.randn((h, w, C), generator=g, device=cuda) for h, w in GAUGE_SHAPES]


@pytest.mark.parametrize("case", ["split_16", "no_split", "scalar_lanes"])
def test_planes_kernel_three_shapes_matches_plain(cuda, case):
    """One launch over planes of three shapes against the plain version
    (1e-5); the corners hit each plane's own corner texels."""
    g = torch.Generator(device=cuda).manual_seed(20)
    planes = _gauge_planes(g, cuda)
    xyz = torch.rand((4001, 3), generator=g, device=cuda) * 2.2 - 1.1
    xyz[:2] = torch.tensor([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], device=cuda)
    coords = [xyz[:, 0:2], xyz[:, 1:3], xyz[:, 0::2]]
    channels, split = {"split_16": (slice(None), 16), "no_split": (slice(None), None),
                       "scalar_lanes": (slice(3, 13), 5)}[case]
    before = cuda_kernels.bilinear_gather_planes.launches
    got = cuda_kernels.bilinear_gather_planes(planes, coords, channels, split)
    assert cuda_kernels.bilinear_gather_planes.launches == before + 1
    want = gs.grid_sample_planes_plain(planes, coords, channels, split)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            assert (a - b).abs().max().item() <= F32_TOL
    full = torch.cat([o for o in got if o is not None], -1)
    for i, plane in enumerate(planes):
        assert torch.equal(full[0, i], plane[0, 0][channels])
        assert torch.equal(full[1, i], plane[-1, -1][channels])


def _coords_case(case, g, cuda, n=5001):
    """(planes, coords, g_a, g_b, c0, split) of one K2c case: the
    projections of ray-consecutive points (runs of shared stencils, some
    leaving [-1, 1]) onto planes of the gauge's three shapes, cotangents as
    strided views (point and plane strides of their own)."""
    P, C, c0, split = 3, 64, 0, 16
    if case in ("one_plane", "two_planes"):
        P = 1 if case == "one_plane" else 2
    elif case == "scalar_lanes":
        c0, C, split = 3, 10, 5
    elif case == "whole_warp":  # 48 float4 lanes a point: segments of two warps
        C, split = 192, 48
    c_total = max(C, 64)
    xyz = torch.cat([_ray_coords(g, cuda, m=80).reshape(-1, 2),
                     torch.rand((64 * 80, 1), generator=g, device=cuda) * 2.2 - 1.1], -1)[:n]
    if case == "random_coords":
        xyz.uniform_(-1.3, 1.3, generator=g)
    xyz[:2] = torch.tensor([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], device=cuda)
    coords = [xyz[:, 0:2], xyz[:, 1:3], xyz[:, 0::2]][:P]
    planes = [torch.randn((h, w, c_total), generator=g, device=cuda) for h, w in GAUGE_SHAPES[:P]]
    g_a = torch.randn((n, P, split + 4), generator=g, device=cuda)[..., :split]
    g_b = torch.randn((n, P, C - split + 4), generator=g, device=cuda)[..., :C - split]
    if case == "one_cotangent":
        g_b = None
    elif case == "second_output_only":
        g_a = None
    return planes, coords, g_a, g_b, c0, split


@pytest.mark.parametrize("case", ["split_16", "random_coords", "one_cotangent", "scalar_lanes",
                                  "one_plane", "two_planes", "second_output_only",
                                  "whole_warp"])
def test_coords_kernel_matches_plain(cuda, case):
    """K2c in one launch over 1 to 3 planes of three shapes against its
    plain version: each plane and coordinate gradient to 1e-5 of its
    largest value; nothing outside the fetched channels; the corners'
    coordinate gradients."""
    g = torch.Generator(device=cuda).manual_seed(21)
    planes, coords, g_a, g_b, c0, split = _coords_case(case, g, cuda)
    grads = [torch.zeros_like(p) for p in planes]
    before = cuda_kernels.bilinear_gather_planes_backward_coords.launches
    got = cuda_kernels.bilinear_gather_planes_backward_coords(planes, coords, g_a, g_b, grads,
                                                             c0, split)
    assert cuda_kernels.bilinear_gather_planes_backward_coords.launches == before + 1
    want_grads = [torch.zeros_like(p) for p in planes]
    want = gs.grid_sample_planes_backward_coords_plain(planes, coords, g_a, g_b, want_grads, c0,
                                                      split)
    assert got.shape == (coords[0].shape[0], len(planes), 2) and got.dtype == torch.float32
    for a, b in (*zip(grads, want_grads), (got, want)):
        scale = b.abs().max().item()
        assert scale > 0 and (a - b).abs().max().item() <= 1e-5 * scale
    lo = c0 if g_a is not None else c0 + split
    hi = c0 + split + (0 if g_b is None else g_b.shape[-1])
    outside = torch.ones(planes[0].shape[-1], dtype=torch.bool, device=cuda)
    outside[lo:hi] = False
    assert not any(grad[..., outside].any() for grad in grads)


def test_coords_kernel_fits_three_blocks_an_sm(cuda):
    """K2c's float4 variant: three 256-thread blocks an SM, no spills."""
    fp = cuda_kernels.backward_coords_footprint(4)
    assert fp["blocks_per_sm"] >= 3 and fp["registers"] <= 80 and fp["local_bytes"] == 0, fp


def test_coords_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    p = torch.zeros((4, 5, 8), device=cuda)
    c = torch.zeros((6, 2), device=cuda)
    ga = torch.zeros((6, 1, 8), device=cuda)
    ga3 = torch.zeros((6, 3, 8), device=cuda)
    bad = [
        ([p.cpu()], [c.cpu()], ga.cpu(), None, [p.cpu()], 0),  # not on the card
        ([p], [c], None, None, [p], 0),  # no cotangent
        ([p], [c], None, ga, [p], 0),  # g_b alone without its split
        ([p.bfloat16()], [c], ga, None, [p], 0),  # bfloat16 plane, float32 cotangent
        ([p], [c], ga, None, [torch.zeros((4, 6, 8), device=cuda)], 0),  # shapes differ
        ([p], [c], ga, None, [p], 1),  # channels past the plane
        ([p], [c], ga[:5], None, [p], 0),  # cotangent rows
        ([p], [c.double()], ga, None, [p], 0),
        ([p.transpose(0, 1)], [c], ga, None, [p.transpose(0, 1)], 0),  # rows not W texels apart
        ([p, p], [c], ga, None, [p, p], 0),  # coords missing
        ([p, p], [c, c], ga, None, [p], 0),  # grads missing
        ([p] * 4, [c] * 4, torch.zeros((6, 4, 8), device=cuda), None, [p] * 4, 0),  # 4 planes
        ([p, p, p], [c, c, c], ga, None, [p, p, p], 0),  # cotangent of one plane for three
        ([p, p, p], [c, c, torch.zeros((5, 2), device=cuda)], ga3, None, [p, p, p], 0),  # coords
        ([p, p, p], [c, c, c.view(3, 2, 2)], ga3, None, [p, p, p], 0),  # coords' batch shape
        ([p, p, torch.zeros((4, 5, 12), device=cuda)], [c, c, c], ga3, None,
         [p, p, torch.zeros((4, 5, 12), device=cuda)], 0),  # channel counts differ
    ]
    for args in bad:
        with pytest.raises(ValueError):
            cuda_kernels.bilinear_gather_planes_backward_coords(*args)


def test_autograd_coordinate_gradient_through_k2c(cuda):
    """``grid_sample_planes`` with coordinates that need a gradient: one K1
    launch forward, one K2c launch for all three planes backward and no K2;
    every gradient against plain autograd's to 1e-5 of its largest."""
    g = torch.Generator(device=cuda).manual_seed(22)
    planes = _gauge_planes(g, cuda)
    xyz = torch.rand((3000, 3), generator=g, device=cuda) * 2.1 - 1.05
    g_a = torch.randn((3000, 3, 16), generator=g, device=cuda)
    g_b = torch.randn((3000, 3, 48), generator=g, device=cuda)
    grads = {}
    for how, fn in (("kernels", gs.grid_sample_planes), ("plain", gs.grid_sample_planes_plain)):
        ps = [p.clone().requires_grad_(True) for p in planes]
        x = xyz.clone().requires_grad_(True)
        names = ("bilinear_gather_planes", "bilinear_gather_2d_backward",
                 "bilinear_gather_planes_backward_coords")
        before = [cuda_kernels.KERNELS[k].launches for k in names]
        out_a, out_b = fn(ps, [x[:, 0:2], x[:, 1:3], x[:, 0::2]], slice(None), 16)
        ((out_a * g_a).sum() + (out_b * g_b).sum()).backward()
        counts = [cuda_kernels.KERNELS[k].launches - b for k, b in zip(names, before)]
        assert counts == ([1, 0, 1] if how == "kernels" else [0, 0, 0])
        grads[how] = [p.grad for p in ps] + [x.grad]
    for a, b in zip(grads["kernels"], grads["plain"]):
        scale = b.abs().max().item()
        assert scale > 0 and (a - b).abs().max().item() <= 1e-5 * scale


def test_gauge_train_step_launches_and_matches_plain(cuda):
    """A grouped gauge train step after ``gauge_start`` on planes of three
    shapes: two K1 launches (gauge grids, planes), three K2 (the gauge
    grids), one K2c (the three planes), one K4; the loss and every gradient
    against the plain sampler (1e-3 of each leaf's largest, as the smoke
    test's step comparison)."""
    from ngf_tpu_torch import convert

    cfg = dataclasses.replace(tt.TriPlaneConfig.gauge_preset(gauge_start=0), plane_res=32,
                              gauge_res=32)
    params = tt.init_triplane(cfg, torch.Generator(device=cuda).manual_seed(5), cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    for name, (h, w) in zip(("plane_xy", "plane_yz", "plane_xz"), GAUGE_SHAPES):
        params[name] = 3.0 * torch.randn((h, w, 64), generator=g, device=cuda)
    for name in ("gauge_xy", "gauge_yz", "gauge_xz"):
        params[name] = 0.02 * torch.randn((32, 32, 2), generator=g, device=cuda)
    leaves = dict(convert.named_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    _, _, rays = _scene(cuda)
    target = torch.rand((rays.shape[0], 3), generator=g, device=cuda)
    rcfg = tv.RenderConfig(aabb=((-1.5,) * 3, (1.5,) * 3), n_samples=60, step_size=0.09,
                           group_size=8, sample_cap=32, tile_q=0)
    names = ("bilinear_gather_planes", "bilinear_gather_2d_backward",
             "bilinear_gather_planes_backward_coords", "group_sample_compact")
    results = {}
    for how, fn in (("kernels", None), ("plain", lambda p, c, name: gs.grid_sample_2d_plain(p, c))):
        for t in leaves.values():
            t.grad = None
        before = [cuda_kernels.KERNELS[k].launches for k in names]
        out = tv.render_rays(params, cfg, rcfg, rays, iteration=1, sample_fn=fn,
                             generator=torch.Generator(device=cuda).manual_seed(7))
        loss = ((out["rgb_map"] - target) ** 2).mean()
        loss.backward()
        counts = [cuda_kernels.KERNELS[k].launches - b for k, b in zip(names, before)]
        if how == "kernels":
            assert counts == [2, 3, 1, 1]
        results[how] = (loss.item(), {k: t.grad.clone() for k, t in leaves.items()})
    assert abs(results["kernels"][0] - results["plain"][0]) <= 1e-5 * results["plain"][0]
    for k, want in results["plain"][1].items():
        scale = want.abs().max().item()
        assert scale > 0, k
        assert (results["kernels"][1][k] - want).abs().max().item() <= 1e-3 * scale, k


@pytest.mark.parametrize("case", [
    "aligned", "density_offset_0", "strided_g_aligned", "strided_g_unaligned", "scalar_lanes",
    "outside", "runs_across_tiles",
])
def test_backward_kernel_bf16_matches_plain(cuda, case):
    """K2 on a bfloat16 cotangent against its plain version on the same
    values (both widen to float32), 1e-5 of the largest gradient, into a
    prefilled float32 buffer; 4-channel lanes where g's offset and stride
    allow 8-byte loads, scalar otherwise."""
    g = torch.Generator(device=cuda).manual_seed(30)
    coords, grad_out, c0 = _k2_inputs(case, g, cuda)
    n, C = grad_out.shape
    start = {"strided_g_aligned": 4, "strided_g_unaligned": 1}.get(case)
    if start is None:
        grad_out = torch.randn((n, C), generator=g, device=cuda).bfloat16()
    else:  # rows 104 channels apart, from channel 4 (8 bytes in) or 1 (2 bytes in)
        grad_out = torch.randn((n, 104), generator=g, device=cuda).bfloat16()[:, start:start + C]
    want_lanes = 1 if case in ("strided_g_unaligned", "scalar_lanes") else 4
    assert cuda_kernels.backward_lanes(C, c0, 96, grad_out.stride(0), grad_out.data_ptr(),
                                       16 * 96, torch.bfloat16) == want_lanes
    prefill = torch.randn((64, 64, 96), generator=g, device=cuda)
    got, want = prefill.clone(), prefill.clone()
    before = cuda_kernels.bilinear_gather_2d_backward.launches
    cuda_kernels.bilinear_gather_2d_backward(grad_out, coords, got, c0)
    assert cuda_kernels.bilinear_gather_2d_backward.launches == before + 1
    gs.grid_sample_2d_backward_plain(grad_out, coords, want, c0)
    scale = (want - prefill).abs().max().item()
    err = (got - want).abs().max().item()
    assert scale > 0 and err <= 1e-5 * scale, f"max abs err {err} of largest {scale}"
    outside = torch.ones(96, dtype=torch.bool)
    outside[c0 : c0 + C] = False
    assert torch.equal(got[..., outside], prefill[..., outside])


@pytest.mark.parametrize("case", ["split_16", "unaligned", "random_coords", "one_cotangent",
                                  "scalar_lanes", "one_plane", "second_output_only"])
def test_coords_kernel_bf16_matches_plain(cuda, case):
    """K2c over bfloat16 values and cotangents of 1 to 3 planes of the
    gauge's three shapes against its plain version on the same values:
    each float32 plane and coordinate gradient to 1e-5 of its largest; the
    cotangents as strided views, 8-byte aligned or not."""
    g = torch.Generator(device=cuda).manual_seed(31)
    planes, coords, g_a, g_b, c0, split = _coords_case(
        {"unaligned": "split_16"}.get(case, case), g, cuda)
    planes = [p.bfloat16() for p in planes]
    n, P = coords[0].shape[0], len(planes)

    def bf16(t, pad):
        if t is None:
            return None
        wide = torch.randn((n, P, t.shape[-1] + pad), generator=g, device=cuda).bfloat16()
        return wide[..., pad:] if case == "unaligned" else wide[..., :t.shape[-1]]

    g_a, g_b = bf16(g_a, 3 if case == "unaligned" else 4), bf16(g_b, 3 if case == "unaligned" else 4)
    grads = [torch.zeros(p.shape, device=cuda) for p in planes]
    before = cuda_kernels.bilinear_gather_planes_backward_coords.launches
    got = cuda_kernels.bilinear_gather_planes_backward_coords(planes, coords, g_a, g_b, grads,
                                                             c0, split)
    assert cuda_kernels.bilinear_gather_planes_backward_coords.launches == before + 1
    want_grads = [torch.zeros(p.shape, device=cuda) for p in planes]
    want = gs.grid_sample_planes_backward_coords_plain(planes, coords, g_a, g_b, want_grads, c0,
                                                      split)
    assert got.dtype == torch.float32 and all(t.dtype == torch.float32 for t in grads)
    for a, b in (*zip(grads, want_grads), (got, want)):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        assert scale > 0 and err <= 1e-5 * scale, f"max abs err {err} of largest {scale}"


def test_coords_kernel_bf16_fits_three_blocks_an_sm(cuda):
    """K2c's bfloat16 variant of 4-channel lanes: three 256-thread blocks an
    SM and no spills, as the float32 one."""
    fp = cuda_kernels.backward_coords_footprint(4, torch.bfloat16)
    assert fp["blocks_per_sm"] >= 3 and fp["registers"] <= 80 and fp["local_bytes"] == 0, fp


def test_bf16_wrappers_refuse_float16_and_mixed_dtypes(cuda):
    """K2 takes a float32 or bfloat16 cotangent into a float32 gradient; K2c
    takes planes and cotangents of one dtype, float32 or bfloat16, and
    float32 gradients. Anything else raises; nothing is cast."""
    c = torch.zeros((6, 2), device=cuda)
    grad = torch.zeros((4, 5, 8), device=cuda)
    for g in (torch.zeros((6, 8), device=cuda, dtype=torch.float16),
              torch.zeros((6, 8), device=cuda, dtype=torch.float64)):
        with pytest.raises(ValueError):
            cuda_kernels.bilinear_gather_2d_backward(g, c, grad)
    with pytest.raises(ValueError):
        cuda_kernels.bilinear_gather_2d_backward(torch.zeros((6, 8), device=cuda), c,
                                                 grad.bfloat16())
    p = torch.zeros((4, 5, 8), device=cuda)
    ga = torch.zeros((6, 1, 8), device=cuda)
    bad = [
        ([p.half()], ga.half(), [grad]),  # float16
        ([p.bfloat16()], ga, [grad]),  # bfloat16 planes, float32 cotangent
        ([p], ga.bfloat16(), [grad]),  # float32 planes, bfloat16 cotangent
        ([p.bfloat16()], ga.bfloat16(), [grad.bfloat16()]),  # bfloat16 gradient
        ([p.bfloat16(), p], ga.expand(6, 2, 8).bfloat16(), [grad, grad]),  # planes' dtypes differ
    ]
    for planes, g_a, grads in bad:
        with pytest.raises(ValueError):
            cuda_kernels.bilinear_gather_planes_backward_coords(
                planes, [c] * len(planes), g_a, None, grads)


def test_autograd_bf16_fetch_through_kernels(cuda):
    """The bfloat16 fetch of float32 planes (``dtype``): one K1 launch on
    the bfloat16 copies, K2 on the bfloat16 cotangents as they come (six),
    or one K2c where the coordinates need a gradient; float32 gradients of
    the float32 planes, equal to the plain versions' on the CPU to 1e-5 of
    the largest."""
    g = torch.Generator(device=cuda).manual_seed(32)
    planes = _gauge_planes(g, cuda)
    xyz = torch.rand((3000, 3), generator=g, device=cuda) * 2.1 - 1.05
    g_a = torch.randn((3000, 3, 16), generator=g, device=cuda).bfloat16()
    g_b = torch.randn((3000, 3, 48), generator=g, device=cuda).bfloat16()
    names = ("bilinear_gather_planes", "bilinear_gather_2d_backward",
             "bilinear_gather_planes_backward_coords")
    for coord_grad in (False, True):
        grads = {}
        for dev in (cuda, torch.device("cpu")):
            ps = [p.detach().to(dev).requires_grad_(True) for p in planes]
            x = xyz.detach().to(dev).requires_grad_(coord_grad)
            before = [cuda_kernels.KERNELS[k].launches for k in names]
            out_a, out_b = gs.grid_sample_planes(ps, [x[:, 0:2], x[:, 1:3], x[:, 0::2]],
                                                 slice(None), 16, dtype=torch.bfloat16)
            assert out_a.dtype == out_b.dtype == torch.bfloat16
            torch.autograd.backward([out_a, out_b], [g_a.to(dev), g_b.to(dev)])
            counts = [cuda_kernels.KERNELS[k].launches - b for k, b in zip(names, before)]
            if dev.type == "cuda":
                assert counts == ([1, 0, 1] if coord_grad else [1, 6, 0]), counts
            grads[dev.type] = [p.grad for p in ps] + ([x.grad] if coord_grad else [])
        for a, b in zip(grads["cuda"], grads["cpu"]):
            assert a.dtype == torch.float32
            scale = b.abs().max().item()
            assert scale > 0 and (a.cpu() - b).abs().max().item() <= 1e-5 * scale


def test_bf16_linear_keeps_float32_products_on_the_card(cuda):
    """The bfloat16 decoder layer on the card (cuBLAS's bfloat16 product
    with a float32 output) against the CPU's product of float32 copies:
    forward and every gradient equal to one bfloat16 unit in the last place
    (2^-7 of the value), where the two float32 sums round to neighbours."""
    from ngf_tpu_torch.fields.decoders import apply_linear

    g = torch.Generator().manual_seed(33)
    x = torch.randn((4096, 72), generator=g)
    w, b = torch.randn((72, 64), generator=g) / 8, torch.randn(64, generator=g)
    gy = torch.randn((4096, 64), generator=g).bfloat16()
    out = {}
    for dev in ("cuda", "cpu"):
        xs, ws, bs = (t.to(dev).requires_grad_(True) for t in (x, w, b))
        y = apply_linear({"w": ws.bfloat16(), "b": bs.bfloat16()}, xs)
        y.backward(gy.to(dev))
        out[dev] = [y.float().cpu(), xs.grad.cpu(), ws.grad.cpu(), bs.grad.cpu()]
    for a, want in zip(out["cuda"], out["cpu"]):
        assert torch.all((a - want).abs() <= 2.0 ** -7 * want.abs() + 1e-6)


def test_bf16_gauge_train_step_launches_and_matches_plain(cuda):
    """A grouped bfloat16 gauge train step after ``gauge_start`` on planes
    of three shapes: two K1 launches (the float32 gauge grids, the bfloat16
    planes), three K2 (the gauge grids), one K2c on the bfloat16 planes and
    cotangents, one K4; the loss and every gradient against the plain
    sampler. Tolerance 3e-2 of each leaf's largest gradient: the kernel and
    the plain gather may round a feature to neighbouring bfloat16 values
    (2^-8), which the bfloat16 decoders carry into every cotangent, and the
    plain route rounds each plane's float32 gradient to bfloat16 once (the
    ``.to`` of its planes), where the kernels add into the float32 planes."""
    from ngf_tpu_torch import convert

    cfg = dataclasses.replace(tt.TriPlaneConfig.gauge_preset(gauge_start=0), plane_res=32,
                              gauge_res=32, compute_dtype="bfloat16")
    params = tt.init_triplane(cfg, torch.Generator(device=cuda).manual_seed(5), cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    for name, (h, w) in zip(("plane_xy", "plane_yz", "plane_xz"), GAUGE_SHAPES):
        params[name] = 3.0 * torch.randn((h, w, 64), generator=g, device=cuda)
    for name in ("gauge_xy", "gauge_yz", "gauge_xz"):
        params[name] = 0.02 * torch.randn((32, 32, 2), generator=g, device=cuda)
    leaves = dict(convert.named_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    _, _, rays = _scene(cuda)
    target = torch.rand((rays.shape[0], 3), generator=g, device=cuda)
    rcfg = tv.RenderConfig(aabb=((-1.5,) * 3, (1.5,) * 3), n_samples=60, step_size=0.09,
                           group_size=8, sample_cap=32, tile_q=0)
    names = ("bilinear_gather_planes", "bilinear_gather_2d_backward",
             "bilinear_gather_planes_backward_coords", "group_sample_compact")

    def plain(p, c, name):
        return gs.grid_sample_2d_plain(p.float(), c).to(p.dtype)

    results = {}
    for how, fn in (("kernels", None), ("plain", plain)):
        for t in leaves.values():
            t.grad = None
        before = [cuda_kernels.KERNELS[k].launches for k in names]
        out = tv.render_rays(params, cfg, rcfg, rays, iteration=1, sample_fn=fn,
                             generator=torch.Generator(device=cuda).manual_seed(7))
        loss = ((out["rgb_map"] - target) ** 2).mean()
        loss.backward()
        counts = [cuda_kernels.KERNELS[k].launches - b for k, b in zip(names, before)]
        if how == "kernels":
            assert counts == [2, 3, 1, 1]
        results[how] = (loss.item(), {k: t.grad.clone() for k, t in leaves.items()})
    assert abs(results["kernels"][0] - results["plain"][0]) <= 1e-2 * results["plain"][0]
    for k, want in results["plain"][1].items():
        scale = want.abs().max().item()
        assert scale > 0, k
        err = (results["kernels"][1][k] - want).abs().max().item()
        assert err <= 3e-2 * scale, (k, err, scale)


# ------------------------------------------------------------------- K5


def _march_inputs(cuda, n, s, seed=0, alpha_one=False, strided=False):
    """K5's inputs at n rays of s samples: densities up to 60 (alpha near 1
    on many samples), a fifth of the samples invalid, the NeuTex segment
    lengths 2/s +- 2.5%, radiance in [0, 1.5], a background per 576 rays
    (one for all where 576 does not divide n)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    density = torch.rand((n, s), generator=g, device=cuda) * 60.0
    if alpha_one:
        density[: n // 2, s // 3] = 1e4  # alpha rounds to 1, f = 1e-10
    valid = torch.rand((n, s), generator=g, device=cuda) > 0.2
    dist = (2.0 / s) * (1.0 + 0.05 * (torch.rand((n, s), generator=g, device=cuda) - 0.5))
    rgb = torch.rand((n, s, 4 if strided else 3), generator=g, device=cuda) * 1.5
    rgb = rgb[..., :3]
    bg = torch.rand((n // 576 if n % 576 == 0 else 1, 3), generator=g, device=cuda)
    return density, valid, dist, rgb, bg


def _march_cotangents(cuda, n, s, seed=1):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn((n, 3), generator=g, device=cuda),
            torch.randn((n, s), generator=g, device=cuda),
            torch.randn((n,), generator=g, device=cuda))


def _close(got, want, what):
    scale = max(want.abs().max().item(), 1e-30)
    err = (got - want).abs().max().item()
    assert err <= F32_TOL * scale, (what, err, scale)


@pytest.mark.parametrize("case", ["train", "render", "large", "alpha_one", "strided", "no_colour"])
def test_ray_march_kernel_matches_plain(cuda, case):
    from ngf_tpu_torch.ops import compositing as tcomp

    n = {"train": 576, "render": 576, "large": 65536}.get(case, 1152)
    s = 64
    density, valid, dist, rgb, bg = _march_inputs(
        cuda, n, s, alpha_one=case == "alpha_one", strided=case == "strided")
    if case == "no_colour":
        rgb = bg = None
    if case == "strided":
        valid = valid.to(torch.uint8)
        density = torch.cat([density, density], dim=1)[:, ::2]
    before = (cuda_kernels.ray_march.launches, cuda_kernels.ray_march_backward.launches)
    got = cuda_kernels.ray_march(density, valid, dist, rgb, bg)
    want = tcomp.ray_march_plain(density, valid, dist, rgb, bg)
    for a, b, what in zip(got, want, ("colour", "w", "T_total")):
        if b is None:
            assert a is None
        else:
            _close(a, b, what)
    if case == "render":
        return
    cots = _march_cotangents(cuda, n, s)
    if rgb is None:
        cots = (None,) + cots[1:]
    got = cuda_kernels.ray_march_backward(density, valid, dist, rgb, bg, *cots)
    want = tcomp.ray_march_backward_plain(density, valid, dist, rgb, bg, *cots)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in got if t is not None)
    _close(got[0], want[0], "d density")
    if rgb is None:
        assert got[1] is None
    else:
        _close(got[1], want[1], "d rgb")
    assert (cuda_kernels.ray_march.launches - before[0],
            cuda_kernels.ray_march_backward.launches - before[1]) == (1, 1)


@pytest.mark.parametrize("which", ["colour", "weights", "transmittance"])
def test_ray_march_autograd_each_cotangent_alone(cuda, which):
    """``march_rays`` on the card (one K5 launch each way) against autograd
    through the plain cumprod version, one output's cotangent at a time."""
    from ngf_tpu_torch.ops import compositing as tcomp

    density, valid, dist, rgb, bg = _march_inputs(cuda, 1152, 64, seed=3)
    density = (density * 0.05).reshape(2, 576, 64)
    rgb, valid, dist = rgb.reshape(2, 576, 64, 3), valid.reshape(2, 576, 64), dist.reshape(2, 576, 64)
    k = ("colour", "weights", "transmittance").index(which)
    grads = []
    for route in ("kernel", "plain"):
        d = density.clone().requires_grad_(True)
        c = rgb.clone().requires_grad_(True)
        before = cuda_kernels.ray_march_backward.launches
        if route == "kernel":
            outs = tcomp.march_rays(d, valid, dist, c, bg)
        else:
            col, w, t = tcomp.ray_march_plain(d.reshape(-1, 64), valid.reshape(-1, 64),
                                              dist.reshape(-1, 64), c.reshape(-1, 64, 3), bg)
            outs = (col.reshape(2, 576, 3), w.reshape(2, 576, 64), t.reshape(2, 576))
        (outs[k] * torch.linspace(-1, 1, outs[k].numel(), device=cuda).reshape(outs[k].shape)).sum().backward()
        if route == "kernel":
            assert cuda_kernels.ray_march_backward.launches == before + 1
        grads.append((d.grad, c.grad))
    _close(grads[0][0], grads[1][0], "d density")
    if which == "colour":
        _close(grads[0][1], grads[1][1], "d rgb")
    else:
        assert grads[0][1].abs().max().item() == 0.0


def test_ray_march_refuses_what_the_kernel_does_not_take(cuda):
    density, valid, dist, rgb, bg = _march_inputs(cuda, 576, 64)
    with pytest.raises(ValueError):
        cuda_kernels.ray_march(density.cpu(), valid, dist, rgb, bg)
    with pytest.raises(ValueError):
        cuda_kernels.ray_march(density.double(), valid, dist, rgb, bg)
    with pytest.raises(ValueError):
        cuda_kernels.ray_march(density, valid.float(), dist, rgb, bg)
    with pytest.raises(ValueError):
        cuda_kernels.ray_march(density, valid, dist, rgb, torch.zeros((5, 3), device=cuda))


# ------------------------------------------------------- K5, tri-plane mode

THRES = 1e-4
TRIPLANE_CASES = ["dense_train", "render", "grouped_draw0", "grouped_draw1", "opaque", "empty",
                  "strided"]


def _triplane_inputs(cuda, case, n=2048, s=300, seed=0):
    """(sigma, dist, rgb, z, ray_last, background, weights) of a tri-plane
    case: densities over five decades across the rays (blend weights on
    both sides of the threshold), dense per-sample lengths with the
    trailing zero or the grouped constant, the background white, drawn 0 or
    1, or none; runs of sigma dist = 20 (alpha 1) up to 88 samples; rays of
    no density and of acc below 6e-8 (rgb_map exactly 1)."""
    if case == "render":
        n, s = 512, 884
    g = torch.Generator(device=cuda).manual_seed(seed)
    z = torch.sort(2.0 + 4.0 * torch.rand((n, s), generator=g, device=cuda), dim=-1).values
    keep = torch.rand((n, s), generator=g, device=cuda) < 0.6
    sigma = 3.0 * torch.rand((n, s), generator=g, device=cuda) * keep
    sigma = sigma * torch.logspace(-5, 0, n, device=cuda)[:, None]
    rgb = torch.rand((n, s, 4 if case == "strided" else 3), generator=g, device=cuda)[..., :3]
    ray_last = 2.0 * torch.rand((n, 6), generator=g, device=cuda)[:, -1] - 1.0
    dist = torch.cat([z[:, 1:] - z[:, :-1], torch.zeros_like(z[:, :1])], -1) * 25.0
    background = {"render": None, "grouped_draw0": torch.zeros((), device=cuda),
                  "grouped_draw1": torch.ones((), device=cuda)}.get(case, 1.0)
    if case.startswith("grouped") or case in ("opaque", "empty"):
        dist = 0.25
        sigma = 8.0 * sigma
    if case == "opaque":
        for i in range(0, n, 2):
            run = (i * 11) % 89
            sigma[i, 5:5 + run] = 80.0
    if case == "empty":
        sigma[: n // 4] = 0.0
        sigma[n // 4: n // 2] = 1e-9
    if case == "strided":
        sigma = torch.cat([sigma, sigma], dim=1)[:, ::2]
        z = z.t().contiguous().t()
        dist = dist.t().contiguous().t()
    return sigma, dist, rgb, z, ray_last, background, case != "render"


@pytest.mark.parametrize("case", TRIPLANE_CASES)
def test_ray_march_triplane_matches_plain(cuda, case):
    """K5's tri-plane mode against ``composite_plain`` and
    ``composite_backward_plain``: acc, depth and w to F32_TOL of their
    scale; rgb_map against the plain sums under the kernel's own mask (a w
    within rounding of the threshold may fall the other way: such samples
    are counted, and their rays left out of the gradients' comparison)."""
    from ngf_tpu_torch.ops import compositing as tcomp

    sigma, dist, rgb, z, ray_last, bg, weights = _triplane_inputs(cuda, case)
    before = (cuda_kernels.ray_march_triplane.launches,
              cuda_kernels.ray_march_triplane_backward.launches)
    rgb_map, y, acc, depth, w = cuda_kernels.ray_march_triplane(
        sigma, dist, rgb, z, ray_last, bg, THRES, weights)
    assert (w is not None) == weights
    if w is None:
        w = cuda_kernels.ray_march_triplane(sigma, dist, rgb, z, ray_last, bg, THRES, True)[4]
    p_map, p_y, p_acc, p_depth, p_w = tcomp.composite_plain(sigma, dist, rgb, z, ray_last, bg,
                                                            THRES)
    for a, b, what in ((acc, p_acc, "acc"), (depth, p_depth, "depth"), (w, p_w, "w")):
        _close(a, b, what)
    flips = (w > THRES) != (p_w > THRES)
    assert bool(((p_w[flips] - THRES).abs() <= 1e-5 * THRES).all()), "a mask bit far from thres"
    mine = (w > THRES).to(w.dtype)
    y_mine = ((p_w * mine)[..., None] * rgb).sum(-2)
    if bg is not None:
        y_mine = y_mine + bg * (1.0 - p_acc[:, None])
    _close(y, y_mine, "y")
    _close(rgb_map, y_mine.clamp(0.0, 1.0), "rgb_map")
    if case == "empty":
        assert bool((rgb_map[: sigma.shape[0] // 2] == 1.0).all())
    if case == "render":
        return
    g = torch.Generator(device=cuda).manual_seed(1)
    g_rgb = torch.randn((sigma.shape[0], 3), generator=g, device=cuda)
    g_acc = torch.randn((sigma.shape[0],), generator=g, device=cuda)
    got = cuda_kernels.ray_march_triplane_backward(sigma, dist, rgb, bg, THRES, y, g_rgb, g_acc)
    want = tcomp.composite_backward_plain(sigma, dist, rgb, bg, THRES, p_y, g_rgb, g_acc)
    torch.cuda.synchronize()
    ok = ~flips.any(-1)
    assert ok.float().mean().item() > 0.99
    for a, b, what in zip(got, want, ("d sigma", "d rgb")):
        assert bool(torch.isfinite(a).all()), what
        _close(a[ok], b[ok], what)
    assert (cuda_kernels.ray_march_triplane.launches - before[0],
            cuda_kernels.ray_march_triplane_backward.launches - before[1]) == (
        1 if weights else 2, 1)


def test_ray_march_triplane_mask_is_the_forwards(cuda):
    """No threshold bit flips between the directions: with a colour
    cotangent of ones and no background, d rgb of a ray inside the clip is
    w m, bit for bit the forward's w and mask."""
    sigma, dist, rgb, z, ray_last, _, _ = _triplane_inputs(cuda, "dense_train", seed=3)
    rgb_map, y, _, _, w = cuda_kernels.ray_march_triplane(sigma, dist, rgb, z, ray_last, None,
                                                          THRES, True)
    ones = torch.ones_like(rgb_map)
    _, d_rgb = cuda_kernels.ray_march_triplane_backward(sigma, dist, rgb, None, THRES, y, ones,
                                                        None)
    inside = ((y > 0) & (y < 1)).all(-1)
    assert inside.float().mean().item() > 0.5
    shaded = w * (w > THRES)
    for ch in range(3):
        assert torch.equal(d_rgb[inside, :, ch], shaded[inside])
    m = (w[inside] > THRES)
    assert bool(m.any()) and bool((~m & (w[inside] > 0)).any())


def test_ray_march_triplane_refuses_what_the_kernel_does_not_take(cuda):
    sigma, dist, rgb, z, ray_last, _, _ = _triplane_inputs(cuda, "dense_train", n=64, s=40)
    rm = cuda_kernels.ray_march_triplane
    with pytest.raises(ValueError):
        rm(sigma.cpu(), dist, rgb, z, ray_last, 1.0, THRES)
    with pytest.raises(ValueError):
        rm(sigma.double(), dist, rgb, z, ray_last, 1.0, THRES)
    with pytest.raises(ValueError):
        rm(sigma, dist, rgb[:, :, :2], z, ray_last, 1.0, THRES)
    with pytest.raises(ValueError):
        rm(sigma, dist[:, :-1], rgb, z, ray_last, 1.0, THRES)
    with pytest.raises(ValueError):
        rm(sigma, dist, rgb, z, ray_last[:-1], 1.0, THRES)
    with pytest.raises(ValueError):
        rm(sigma, dist, rgb, z, ray_last, torch.ones(2, device=cuda), THRES)
    with pytest.raises(ValueError):
        rm(sigma[:, :0], dist[:, :0], rgb[:, :0], z[:, :0], ray_last, 1.0, THRES)
    big = cuda_kernels.MARCH_MAX_SAMPLES + 1
    with pytest.raises(ValueError):
        rm(torch.zeros((1, big), device=cuda), 0.25, torch.zeros((1, big, 3), device=cuda),
           torch.zeros((1, big), device=cuda), ray_last[:1], 1.0, THRES)
    with pytest.raises(ValueError):
        cuda_kernels.ray_march_triplane_backward(sigma, dist, rgb, 1.0, THRES, None,
                                                 torch.ones((64, 3), device=cuda), None)
    lib = cuda_kernels._lib("ray_march")
    assert lib.ngf_ray_march_max_samples() == cuda_kernels.MARCH_MAX_SAMPLES


@pytest.mark.parametrize("path", ["dense_eval", "grouped_train"])
def test_renders_composite_through_one_k5_launch_each_way(cuda, path):
    """A dense evaluation chunk composites in one K5 tri-plane launch, a
    grouped train step in one forward and one backward, and no
    ``aten::cumprod`` runs (profiler rows); the outputs against the
    CPU's plain pair on the same fields to RENDER_TOL."""
    from torch.profiler import ProfilerActivity, profile

    from ngf_tpu_torch.ops import compositing as tcomp

    cfg, params, rays = _scene(cuda, seed=6)
    grouped = path == "grouped_train"
    rcfg = tv.RenderConfig(aabb=((-1.5,) * 3, (1.5,) * 3), n_samples=60, step_size=0.09,
                           group_size=8 if grouped else 0, tile_q=0, white_bg=not grouped)
    names = ("ray_march_triplane", "ray_march_triplane_backward")
    captured = {}
    composite = tcomp.composite

    def spy(*args, **kw):
        captured["args"] = (args, kw)
        return composite(*args, **kw)

    tv.composite = spy
    try:
        before = [cuda_kernels.KERNELS[k].launches for k in names]
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            leaf = params["plane_xy"].requires_grad_(grouped)
            out = tv.render_rays(params, cfg, rcfg, rays, generator=torch.Generator(
                device=cuda).manual_seed(3) if grouped else None)
            if grouped:
                (out["rgb_map"].sum() + out["acc_map"].sum()).backward()
        counts = [cuda_kernels.KERNELS[k].launches - b for k, b in zip(names, before)]
    finally:
        tv.composite = composite
        params["plane_xy"].requires_grad_(False)
    assert counts == ([1, 1] if grouped else [1, 0])
    assert not [e for e in prof.key_averages() if "cumprod" in e.key]
    if grouped:
        assert leaf.grad is not None and leaf.grad.abs().max().item() > 0
        assert out["shaded_groups"].dtype == torch.int32
    args, kw = captured["args"]
    cpu = [a.detach().cpu() if isinstance(a, torch.Tensor) else a for a in args]
    want = tcomp.composite_plain(*cpu[:6], cpu[6])
    for k, ref in zip(("rgb_map", "acc_map", "depth_map"), (want[0], want[2], want[3])):
        assert (out[k].detach().cpu() - ref).abs().max().item() <= RENDER_TOL, k


def test_uv_train_steps_launch_k5_and_match_the_cpu(cuda):
    """Two `UVTrainer` steps of a small NeuTex on the card (one K5 launch
    each way a step) against the same steps on the CPU (K5's plain
    versions), from the same weights and draws: the first step's losses to
    1e-4 (float32 sums in another order), the second's to 1e-3 (Adam's first
    move turns gradients at the level of float32 rounding into moves of lr
    either way)."""
    from ngf_tpu_torch.data.dtu import SyntheticDtuDataset
    from ngf_tpu_torch.fields.neutex import NeuTexConfig
    from ngf_tpu_torch.train.uv_loop import UVTrainer

    cfg = NeuTexConfig(sample_num=16, points_per_primitive=64, geo_hidden=64, geo_layers=3,
                       tex_width=64, tex_layers1=2, tex_layers2=1)
    ds = SyntheticDtuDataset(n_views=4, wh=(16, 16), random_sample="balanced",
                             random_sample_size=8, seed=0)
    items = [ds.sample() for _ in range(2)]
    g = torch.Generator().manual_seed(0)
    draws = [{"u": torch.rand((1, 64, 16), generator=g),
              "template": torch.rand((64, 2), generator=g) * 2 - 1} for _ in items]
    on_card, on_cpu = UVTrainer(cfg, ds, seed=3, device=cuda), UVTrainer(cfg, ds, device="cpu")
    on_cpu.load_params(on_card.params)
    before = (cuda_kernels.ray_march.launches, cuda_kernels.ray_march_backward.launches)
    got = on_card.train_block(items, draws=draws)
    assert (cuda_kernels.ray_march.launches - before[0],
            cuda_kernels.ray_march_backward.launches - before[1]) == (2, 2)
    want = on_cpu.train_block(items, draws=draws)
    for k, w in want.items():
        for step, rtol in ((0, 1e-4), (1, 1e-3)):
            assert abs(got[k][step] - w[step]) <= rtol * max(abs(w[step]), 1e-6), (k, step)


def test_uv_captured_steps_equal_eager_steps(cuda, tmp_path, monkeypatch):
    """Nine `UVTrainer` steps on the card: the first `GRAPH_WARMUP` eager,
    then the captured step replayed, against the same steps all eager (the
    warm-up longer than the run): each loss and every parameter equal bit
    for bit (the replays run the eager step's kernels on the same inputs),
    the rate followed through the 'lambda' decay that starts at step 4. A
    traced step between them runs as the untraced ones do, with its spans'
    device time, and the device trace shows it running K5 once forward and
    once backward. K5's launch counter counts the host's launches: one
    forward and one backward an eager step and at the capture, none a
    replay."""
    import numpy as np

    from ngf_tpu_torch.data.dtu import SyntheticDtuDataset
    from ngf_tpu_torch.fields.neutex import NeuTexConfig
    from ngf_tpu_torch.train import uv_loop
    from ngf_tpu_torch.utils import profiling

    cfg = NeuTexConfig(sample_num=16, points_per_primitive=64, geo_hidden=64, geo_layers=3,
                       tex_width=64, tex_layers1=2, tex_layers2=1)
    ds = SyntheticDtuDataset(n_views=4, wh=(16, 16), random_sample="balanced",
                             random_sample_size=8, seed=0)
    items = [ds.sample() for _ in range(9)]
    weights = {"color": 1.0, "bg": 1.0, "origin": 1.0, "inverse_mapping": 1.0}
    runs = []
    for warmup, host in ((uv_loop.GRAPH_WARMUP, uv_loop.GRAPH_WARMUP + 1), (10 ** 9, 9)):
        monkeypatch.setattr(uv_loop, "GRAPH_WARMUP", warmup)
        tr = uv_loop.UVTrainer(cfg, ds, seed=3, niter=4, niter_decay=10, loss_weights=weights,
                               device=cuda)
        before = (cuda_kernels.ray_march.launches, cuda_kernels.ray_march_backward.launches)
        losses = tr.train_block(items[:6])
        with profiling.trace(str(tmp_path / f"tb{warmup}")) as prof:
            losses_t = tr.train_block(items[6:7])
            torch.cuda.synchronize()
        rep = profiling.report()
        losses_after = tr.train_block(items[7:])
        assert (cuda_kernels.ray_march.launches - before[0],
                cuda_kernels.ray_march_backward.launches - before[1]) == (host, host)
        ran = [(e.key, e.count) for e in prof.key_averages()]
        assert [sum(n for k, n in ran if f"ray_march_neutex_{d}_kernel" in k)
                for d in ("forward", "backward")] == [1, 1], ran
        spans = rep["spans"]
        assert spans["ngf.field"]["count"] == 1 and spans["ngf.field"]["device_ms"] > 0
        assert spans["ngf.uv.gauge"]["parents"] == ["ngf.field"]
        assert spans["ngf.backward"]["device_ms"] > 0
        assert rep["counters"]["slots"] == 8 * 8 * 16 and rep["counters"]["template"] == 64
        assert (tr._graph is not None) == (warmup < 9)
        runs.append((losses, losses_t, losses_after,
                     [t.detach().cpu() for _, t in uv_loop.sorted_named_leaves(tr.params)]))
    (a, at, aa, pa), (b, bt, bb, pb) = runs
    for x, y in ((a, b), (at, bt), (aa, bb)):
        for k in y:
            assert np.array_equal(x[k], y[k]), k
    assert all(torch.equal(s, t) for s, t in zip(pa, pb))


def _shard_inputs(cuda, n, s, seed=0, t0="random"):
    """A shard of the sample-parallel path: sigma over five decades with
    runs of sigma dist = 20 on every other ray, the path's one length, rgb,
    z, and t0 random in (0, 1], 0 (behind opaque shards) on a quarter of
    the rays, or all 1."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    dist = 0.25
    sigma = 24.0 * torch.rand((n, s), generator=g, device=cuda) * (
        torch.rand((n, s), generator=g, device=cuda) < 0.6)
    sigma = sigma * torch.logspace(-5, 0, n, device=cuda)[:, None]
    for i in range(0, n, 2):
        sigma[i, 3:3 + (i * 7) % 61] = 80.0
    rgb = torch.rand((n, s, 3), generator=g, device=cuda)
    z = torch.sort(2.0 + 4.0 * torch.rand((n, s), generator=g, device=cuda), dim=-1).values
    t0v = 1.0 - torch.rand((n,), generator=g, device=cuda)
    if t0 == "zero":
        t0v[: n // 4] = 0.0
    elif t0 == "one":
        t0v = torch.ones_like(t0v)
    return sigma, dist, rgb, z, t0v


@pytest.mark.parametrize("shape,t0", [((4096, 442), "random"), ((4096, 221), "random"),
                                      ((2048, 442), "zero")])
def test_ray_march_triplane_shard_matches_plain(cuda, shape, t0):
    """K5's shard mode against ``composite_shard_totals_plain``,
    ``composite_shard_plain`` and ``composite_shard_backward_plain``: t_end,
    the partial sums, the local sums and w to F32_TOL of their scale (y
    against the plain sums under the kernel's own mask), the gradients of
    sigma, rgb and t0 likewise on the rays whose mask agrees; no NaN where
    t0 = 0 or alpha rounds to 1."""
    from ngf_tpu_torch.ops import compositing as tcomp

    sigma, dist, rgb, z, t0v = _shard_inputs(cuda, *shape, t0=t0)
    names = ("ray_march_triplane_totals", "ray_march_triplane_shard",
             "ray_march_triplane_shard_backward")
    before = [cuda_kernels.KERNELS[k].launches for k in names]
    t_end = cuda_kernels.ray_march_triplane_totals(sigma, dist)
    y, acc, depth, local, w = cuda_kernels.ray_march_triplane_shard(sigma, dist, rgb, z, t0v,
                                                                    THRES, True)
    g = torch.Generator(device=cuda).manual_seed(2)
    g_y, g_acc, g_tend = (torch.randn(s_, generator=g, device=cuda)
                          for s_ in ((shape[0], 3), (shape[0],), (shape[0],)))
    got = cuda_kernels.ray_march_triplane_shard_backward(sigma, dist, rgb, t0v, THRES, g_y, g_acc,
                                                         g_tend)
    torch.cuda.synchronize()
    assert [cuda_kernels.KERNELS[k].launches - b for k, b in zip(names, before)] == [1, 1, 1]
    _close(t_end, tcomp.composite_shard_totals_plain(sigma, dist), "t_end")
    p_y, p_acc, p_depth, p_local, p_w = tcomp.composite_shard_plain(sigma, dist, rgb, z, t0v, THRES)
    for a, b, what in ((acc, p_acc, "acc"), (depth, p_depth, "depth"), (w, p_w, "w"),
                       (local[:, 3], p_local[:, 3], "acc_loc")):
        _close(a, b, what)
    flips = (w > THRES) != (p_w > THRES)
    assert bool(((p_w[flips] - THRES).abs() <= 1e-5 * THRES).all()), "a mask bit far from thres"
    mine = (w > THRES).to(w.dtype)
    _close(y, ((p_w * mine)[..., None] * rgb).sum(-2), "y")
    wl = p_w / torch.where(t0v > 0, t0v, 1.0)[:, None]
    ok = ~flips.any(-1) & (t0v > 0)
    _close(local[ok, :3], ((wl * mine)[..., None] * rgb).sum(-2)[ok], "y_loc")
    want = tcomp.composite_shard_backward_plain(sigma, dist, rgb, t0v, THRES, g_y, g_acc, g_tend)
    ok = ~flips.any(-1)
    assert ok.float().mean().item() > 0.99
    for a, b, what in zip(got, want, ("d sigma", "d rgb", "d t0")):
        assert bool(torch.isfinite(a).all()), what
        _close(a[ok], b[ok], what)
    for t in (t_end, y, acc, depth, local, w):
        assert bool(torch.isfinite(t).all())
    if t0 == "zero":
        assert bool((y[: shape[0] // 4] == 0).all() and (acc[: shape[0] // 4] == 0).all())


@pytest.mark.parametrize("split", [442, 221, 100])
def test_ray_march_triplane_shard_split_identity(cuda, split):
    """Two chained shard launches (the first from t0 = 1, the second from
    the first's t_end) against one whole-ray tri-plane launch of the 884
    samples: w, acc, depth and rgb_map to 1e-6 of their scale (the same
    float32 scan with the products associated at the split), the shading
    mask equal."""
    sigma, dist, rgb, z, _ = _shard_inputs(cuda, 4096, 884, seed=5)
    ray_last = torch.zeros((4096,), device=cuda)
    rgb_map, _, acc, depth, w = cuda_kernels.ray_march_triplane(sigma, dist, rgb, z, ray_last, 1.0,
                                                                THRES, True)
    a = (sigma[:, :split], dist, rgb[:, :split], z[:, :split])
    b = (sigma[:, split:], dist, rgb[:, split:], z[:, split:])
    t_a = cuda_kernels.ray_march_triplane_totals(a[0], dist)
    ya, acc_a, d_a, _, w_a = cuda_kernels.ray_march_triplane_shard(*a, torch.ones_like(t_a), THRES,
                                                                   True)
    yb, acc_b, d_b, _, w_b = cuda_kernels.ray_march_triplane_shard(*b, t_a, THRES, True)
    acc2 = acc_a + acc_b
    map2 = (ya + yb + (1.0 - acc2[:, None])).clamp(0.0, 1.0)
    w2 = torch.cat([w_a, w_b], 1)
    for got, want, what in ((w2, w, "w"), (acc2, acc, "acc"), (d_a + d_b, depth, "depth"),
                            (map2, rgb_map, "rgb_map")):
        err = (got - want).abs().max().item()
        assert err <= 1e-6 * max(want.abs().max().item(), 1.0), (what, err)
    assert torch.equal(w2 > THRES, w > THRES)


def test_composite_shard_three_launches_through_autograd(cuda):
    """``composite_shard`` on the card: one totals launch, one composite
    launch and one backward launch, and the outputs and gradients of sigma
    and rgb of two chained shards against the same on the CPU (the plain
    versions) to F32_TOL of their scale."""
    from ngf_tpu_torch.ops import compositing as tcomp

    sigma, dist, rgb, z, _ = _shard_inputs(cuda, 512, 120, seed=7)
    names = ("ray_march_triplane_totals", "ray_march_triplane_shard",
             "ray_march_triplane_shard_backward")
    g = torch.Generator(device=cuda).manual_seed(3)
    g_y, g_acc = torch.randn((512, 3), generator=g, device=cuda), torch.randn((512,), generator=g,
                                                                              device=cuda)

    def run(device):
        s_ = sigma.detach().to(device, copy=True).requires_grad_(True)
        c_ = rgb.detach().to(device, copy=True).requires_grad_(True)
        held = {}

        def first(t_end):
            held["t"] = t_end
            return torch.ones_like(t_end) + 0.0 * t_end

        ya, acc_a, _ = tcomp.composite_shard(s_[:, :60], dist, c_[:, :60], z[:, :60].to(device),
                                             THRES, first)
        yb, acc_b, _ = tcomp.composite_shard(s_[:, 60:], dist, c_[:, 60:], z[:, 60:].to(device),
                                             THRES, lambda t_end: held["t"] + 0.0 * t_end)
        y, acc = ya + yb, acc_a + acc_b
        ((y * g_y.to(device)).sum() + (acc * g_acc.to(device)).sum()).backward()
        return y.detach().cpu(), acc.detach().cpu(), s_.grad.cpu(), c_.grad.cpu()

    before = [cuda_kernels.KERNELS[k].launches for k in names]
    got = run(cuda)
    assert [cuda_kernels.KERNELS[k].launches - b for k, b in zip(names, before)] == [2, 2, 2]
    for a, b, what in zip(got, run("cpu"), ("y", "acc", "d sigma", "d rgb")):
        _close(a, b, what)


def test_ray_march_triplane_shard_refuses_what_the_kernel_does_not_take(cuda):
    sigma, dist, rgb, z, t0v = _shard_inputs(cuda, 64, 40)
    with pytest.raises(ValueError):
        cuda_kernels.ray_march_triplane_totals(sigma.cpu(), dist)
    with pytest.raises(ValueError):
        cuda_kernels.ray_march_triplane_shard(sigma, dist, rgb, z, t0v[:-1], THRES)
    with pytest.raises(ValueError):
        cuda_kernels.ray_march_triplane_shard(sigma, dist, rgb, z, t0v.double(), THRES)
    with pytest.raises(ValueError):
        cuda_kernels.ray_march_triplane_shard(sigma, dist, rgb, z[:, 1:], t0v, THRES)
    with pytest.raises(ValueError):
        cuda_kernels.ray_march_triplane_shard_backward(sigma, dist, rgb, t0v, THRES,
                                                       torch.ones((64, 2), device=cuda), None, None)
    fp = cuda_kernels.ray_march_footprint(442)
    for k in ("shard_forward", "shard_backward", "shard_totals"):
        assert fp[k]["blocks_per_sm"] >= 1 and fp[k]["local_bytes"] == 0, (k, fp[k])


# ------------------------------------------------ K5 top-K mode, row scatter


def _topk_case(cuda, case, n=2048, s=304, seed=0):
    """A top-K case on the tri-plane inputs of ``case``: the weight launch's
    w and acc (no colour), the picks as the renderers make them (the top
    ``k`` samples, or the top groups of 8 by their best weight), the
    selected samples' colours (N, K, 3) and the background."""
    sigma, dist, rgb, z, ray_last, bg, _ = _triplane_inputs(cuda, case, n=n, s=s, seed=seed)
    _, _, acc, depth, w = cuda_kernels.ray_march_triplane(sigma, dist, None, z, ray_last, bg,
                                                          THRES, True)
    group = 1 if case.startswith("dense") or case == "strided" else 8
    best = w if group == 1 else w.view(n, s // group, group).amax(-1)
    idx = torch.topk(best, 48 if group == 1 else 6, dim=-1).indices
    g = torch.Generator(device=cuda).manual_seed(seed + 9)
    rgb_k = torch.rand((n, idx.shape[1] * group, 4), generator=g, device=cuda)[..., :3]
    return sigma, dist, z, ray_last, bg, w, acc, depth, idx, group, rgb_k


@pytest.mark.parametrize("case", ["dense_train", "grouped_draw0", "grouped_draw1", "opaque",
                                  "empty", "strided"])
def test_ray_march_triplane_topk_matches_plain(cuda, case):
    """K5's top-K mode against its plain versions: the weight launch (the
    tri-plane forward without rgb: w, acc and depth against
    ``composite_plain``'s), the colour pass against ``composite_topk_plain``
    (y against the plain sums under the kernel's own mask), its backward
    against ``composite_topk_backward_plain`` (g_w, d acc, d rgb_k), and the
    weight backward with that g_w against ``composite_backward_plain``'s
    ``g_w`` input; one launch each."""
    from ngf_tpu_torch.ops import compositing as tcomp

    names = ("ray_march_triplane", "ray_march_triplane_topk", "ray_march_triplane_topk_backward",
             "ray_march_triplane_backward")
    before = [cuda_kernels.KERNELS[k].launches for k in names]
    sigma, dist, z, ray_last, bg, w, acc, depth, idx, group, rgb_k = _topk_case(cuda, case)
    p_w = tcomp.raw2alpha(sigma, dist)[1]
    _close(w, p_w, "w")
    _close(acc, p_w.sum(-1), "acc")
    _close(depth, (p_w * z).sum(-1) + (1.0 - p_w.sum(-1)) * ray_last, "depth")
    rgb_map, y = cuda_kernels.ray_march_triplane_topk(w, acc, idx, group, rgb_k, bg, THRES)
    p_map, p_y = tcomp.composite_topk_plain(w, acc, idx, group, rgb_k, bg, THRES)
    _close(y, p_y, "y")  # the plain version on the kernel's own w: the same mask
    _close(rgb_map, p_map, "rgb_map")
    g = torch.Generator(device=cuda).manual_seed(1)
    g_rgb = torch.randn((w.shape[0], 3), generator=g, device=cuda)
    g_acc = torch.randn((w.shape[0],), generator=g, device=cuda)
    g_w, d_acc, d_rgb = cuda_kernels.ray_march_triplane_topk_backward(w, idx, group, rgb_k, bg,
                                                                      THRES, y, g_rgb)
    want = tcomp.composite_topk_backward_plain(w, idx, group, rgb_k, bg, THRES, p_y, g_rgb)
    for a, b, what in zip((g_w, d_acc, d_rgb), want, ("g_w", "d acc", "d rgb_k")):
        _close(a, b, what)
    assert int((g_w != 0).sum(-1).max()) <= idx.shape[1] * group
    d_sigma, d_rgb_none = cuda_kernels.ray_march_triplane_backward(
        sigma, dist, None, None, 0.0, None, None, g_acc + d_acc, g_w)
    p_sigma, _ = tcomp.composite_backward_plain(sigma, dist, None, None, 0.0, None, None,
                                                g_acc + d_acc, g_w)
    torch.cuda.synchronize()
    assert d_rgb_none is None and bool(torch.isfinite(d_sigma).all())
    _close(d_sigma, p_sigma, "d sigma")
    assert [cuda_kernels.KERNELS[k].launches - b for k, b in zip(names, before)] == [1, 1, 1, 1]
    if case == "empty":
        assert bool((rgb_map[: w.shape[0] // 2] == 1.0).all())


@pytest.mark.parametrize("path", ["dense", "grouped", "grouped_fused"])
def test_topk_train_render_launches_and_matches_the_cpu(cuda, path, monkeypatch):
    """A training render with top-K shading on the card: the weight launch
    and the colour pass forward, their two backward launches, one
    ``gather_rows`` of the picks and, where what it gathers takes a gradient
    (the fused fetch's features), one ``scatter_rows``; no
    ``aten::cumprod``; rgb, acc, depth and the plane gradient against the
    same render on the CPU (plain versions) with the same jitter."""
    from torch.profiler import ProfilerActivity, profile

    cfg, params, rays = _scene(cuda, seed=6)
    rcfg = tv.RenderConfig(aabb=((-1.5,) * 3, (1.5,) * 3), n_samples=64, step_size=0.09,
                           group_size=0 if path == "dense" else 8, tile_q=0, rgb_cap=16,
                           fused_fetch=path == "grouped_fused")
    jitter = torch.rand((rays.shape[0], 1), generator=torch.Generator(device=cuda).manual_seed(4),
                        device=cuda)
    monkeypatch.setattr(tv, "_ray_jitter", lambda g, n, device: jitter.to(device))
    names = ("ray_march_triplane", "ray_march_triplane_topk", "ray_march_triplane_backward",
             "ray_march_triplane_topk_backward", "gather_rows", "scatter_rows",
             "bilinear_gather_planes")

    def run(device):
        p = _tree_map(params, lambda t: t.detach().to(device, copy=True))
        leaf = p["plane_xy"].requires_grad_(True)
        out = tv.render_rays(p, cfg, rcfg, rays.to(device),
                             generator=torch.Generator(device=device).manual_seed(3))
        (out["rgb_map"].sum() + out["acc_map"].sum()).backward()
        return out, leaf.grad

    before = [cuda_kernels.KERNELS[k].launches for k in names]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, grad = run(cuda)
    counts = dict(zip(names, (cuda_kernels.KERNELS[k].launches - b for k, b in zip(names, before))))
    assert not [e for e in prof.key_averages() if "cumprod" in e.key]
    assert counts == {"ray_march_triplane": 1, "ray_march_triplane_topk": 1,
                      "ray_march_triplane_backward": 1, "ray_march_triplane_topk_backward": 1,
                      "gather_rows": 1, "scatter_rows": int(path == "grouped_fused"),
                      "bilinear_gather_planes": 1 if path == "grouped_fused" else 2}, counts
    want, want_grad = run(torch.device("cpu"))
    for k in ("rgb_map", "acc_map", "depth_map"):
        assert (out[k].detach().cpu() - want[k].detach()).abs().max().item() <= RENDER_TOL, k
    # A plane's gradient sums thousands of terms of both signs whose
    # float32 roundings differ between the card and the CPU (chip_smoke.py's
    # STEP_GRAD_REL_TOL, for a train step against the plain sampler).
    scale = want_grad.abs().max().item()
    assert scale > 0 and (grad.cpu() - want_grad).abs().max().item() <= 1e-3 * scale


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(v, fn) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("variant", ["infoinv", "gauge"])
def test_packed_train_render_launches_and_matches_the_cpu(cuda, variant, monkeypatch):
    """A grouped training render with dense shading packs its kept groups:
    K4 once, two ``gather_rows`` (the kept groups' coordinates and view
    directions) and two ``scatter_rows`` (sigma and colour back into the
    slot layout) forward, two ``gather_rows`` backward, and fewer rows
    decoded than the slot layout holds; rgb, acc, depth and every leaf's
    gradient against the same render on the CPU (plain versions) with the
    same jitter. With its front end on a second stream (``front_stream``,
    as the trainer runs it, after the current stream has queued other
    work) the outputs are those of the render on one stream, bit for bit,
    and the gradients within the atomics' rounding."""
    from ngf_tpu_torch import convert

    cfg, params, rays = _scene(cuda, seed=7)
    if variant == "gauge":
        cfg = dataclasses.replace(tt.TriPlaneConfig.gauge_preset(gauge_start=0), plane_res=32,
                                  gauge_res=32)
        params = tt.init_triplane(cfg, torch.Generator(device=cuda).manual_seed(7), cuda)
        g = torch.Generator(device=cuda).manual_seed(8)
        for name in ("plane_xy", "plane_yz", "plane_xz"):
            params[name] = 3.0 * torch.randn(params[name].shape, generator=g, device=cuda)
        for name in ("gauge_xy", "gauge_yz", "gauge_xz"):
            params[name] = 0.02 * torch.randn((32, 32, 2), generator=g, device=cuda)
    rcfg = tv.RenderConfig(aabb=((-1.5,) * 3, (1.5,) * 3), n_samples=60, step_size=0.09,
                           group_size=8, tile_q=0)
    vol = _ball((16, 16, 16), cuda)
    jitter = torch.rand((rays.shape[0], 1), generator=torch.Generator(device=cuda).manual_seed(9),
                        device=cuda)
    monkeypatch.setattr(tv, "_ray_jitter", lambda g, n, device: jitter.to(device))
    packed = []
    pack_map = tv._pack_map

    def spy(got):
        ids = pack_map(got)
        packed.append((ids.shape[0], int(got.sum()), got.numel()))
        return ids

    monkeypatch.setattr(tv, "_pack_map", spy)
    names = ("gather_rows", "scatter_rows", "group_sample_compact", "bilinear_gather_planes")

    def run(device, front=None):
        p = _tree_map(params, lambda t: t.detach().to(device, copy=True))
        leaves = dict(convert.named_leaves(p))
        for t in leaves.values():
            t.requires_grad_(True)
        if front is not None:
            # Inputs written here first, then unrelated work queued, as the
            # trainer's previous step leaves the current stream.
            front.wait_stream(torch.cuda.current_stream())
            busy = torch.randn((2048, 2048), device=device)
            for _ in range(20):
                busy = busy @ busy.t() / 2048
        out = tv.render_rays(p, cfg, rcfg, rays.to(device), iteration=1,
                             alpha_volume=vol.to(device),
                             generator=torch.Generator(device=device).manual_seed(3),
                             front_stream=front)
        (out["rgb_map"].sum() + out["acc_map"].sum()).backward()
        return out, {k: t.grad for k, t in leaves.items()}

    before = [cuda_kernels.KERNELS[k].launches for k in names]
    out, grads = run(cuda)
    counts = dict(zip(names, (cuda_kernels.KERNELS[k].launches - b for k, b in zip(names, before))))
    assert counts == {"gather_rows": 4, "scatter_rows": 2, "group_sample_compact": 1,
                      "bilinear_gather_planes": 2 if variant == "gauge" else 1}, counts
    rows, kept, slots = packed[0]
    assert 0 < kept == rows < slots
    side, side_grads = run(cuda, torch.cuda.Stream(cuda))
    for k in ("rgb_map", "acc_map", "depth_map"):
        assert torch.equal(side[k], out[k]), k
    for k, g in grads.items():
        scale = max(g.abs().max().item(), 1e-30)
        assert (side_grads[k] - g).abs().max().item() <= 1e-4 * scale, k
    want, want_grads = run(torch.device("cpu"))
    assert packed[1] == packed[0] == packed[2]
    assert 0.02 < want["acc_map"].detach().mean().item() < 0.98
    for k in ("rgb_map", "acc_map", "depth_map"):
        assert (out[k].detach().cpu() - want[k].detach()).abs().max().item() <= RENDER_TOL, k
    # As the top-K render's test: float32 sums of thousands of terms of both
    # signs, rounded otherwise on the card and the CPU.
    for k, w in want_grads.items():
        scale = w.abs().max().item()
        assert scale > 0, k
        assert (grads[k].cpu() - w).abs().max().item() <= 1e-3 * scale, k


def test_ray_march_triplane_topk_refuses_what_the_kernel_does_not_take(cuda):
    sigma, dist, z, ray_last, bg, w, acc, depth, idx, group, rgb_k = _topk_case(
        cuda, "grouped_draw1", n=64, s=80)
    tk = cuda_kernels.ray_march_triplane_topk
    with pytest.raises(ValueError):
        tk(w.cpu(), acc, idx, group, rgb_k, bg, THRES)
    with pytest.raises(ValueError):
        tk(w.t().contiguous().t(), acc, idx, group, rgb_k, bg, THRES)  # w not contiguous
    with pytest.raises(ValueError):
        tk(w, acc, idx.int(), group, rgb_k, bg, THRES)
    with pytest.raises(ValueError):
        tk(w, acc, idx, group, rgb_k[:, 1:], bg, THRES)
    with pytest.raises(ValueError):
        tk(w, acc[1:], idx, group, rgb_k, bg, THRES)
    with pytest.raises(ValueError):
        tk(w, acc, idx, 3, rgb_k, bg, THRES)  # groups of 3 do not tile 80 samples
    with pytest.raises(ValueError):
        cuda_kernels.ray_march_triplane_topk_backward(w, idx, group, rgb_k, bg, THRES, None,
                                                      torch.ones((64, 3), device=cuda))
    fp = cuda_kernels.ray_march_footprint(512)
    for k in ("topk_forward", "topk_backward"):
        assert fp[k]["blocks_per_sm"] >= 1 and fp[k]["local_bytes"] == 0, (k, fp[k])


def _same_row_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Byte for byte: the kernels' NaN rows are the plain versions' NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.contiguous().view(bits), b.contiguous().view(bits))


def _segment_ids(g, n: int, ng: int, k: int, outside: bool, cuda) -> torch.Tensor:
    """(n, k) distinct ids of each ray's ng groups; ``outside``: k = 5 ids
    -1, -ng, ng, -ng - 1 and 2 in each ray's own order (two wrap, two name
    no row)."""
    if not outside:
        return torch.stack([torch.randperm(ng, generator=g, device=cuda)[:k] for _ in range(n)])
    ids = torch.tensor([-1, -ng, ng, -ng - 1, 2], device=cuda)
    return torch.stack([ids[torch.randperm(5, generator=g, device=cuda)] for _ in range(n)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index_dtype", [torch.int64, torch.int32])
def test_gather_and_scatter_rows_match_plain(cuda, dtype, index_dtype):
    """``gather_rows`` and its backward ``scatter_rows`` against their plain
    versions, byte for byte, one launch a call: rows of 1728 and 48 values
    (16-byte words), 6 and 3 (narrow words), each from a contiguous table, a
    column-offset view and a table at a storage offset of one element (neither
    16-byte aligned: the element's word); ids of the batch form (per 0, with
    rows outside the table), relative to segments, and outside their
    segment (take_along_axis: wrapped or NaN, and dropped by the scatter);
    segments of 12288 rows (the scatter's one kernel a segment) and 12289
    (its fill and row writes). Then the group gather through autograd, the
    refusals and the footprints (no spills)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    e = torch.tensor([], dtype=dtype).element_size()
    n, ng, k = 64, 14, 5
    R = n * ng
    for d in (1728, 48, 6, 3):
        base = torch.randn((R + 1, d + 1), generator=g, device=cuda).to(dtype)
        tables = {"contiguous": base[:R, :d].contiguous(), "column offset": base[:R, 1:],
                  "storage offset": base.reshape(-1)[1:1 + R * d].view(R, d)}
        for layout, tab in tables.items():
            want_lane = next(v for v in (16, 8, 4, 2, e) if (d * e) % v == 0 and v >= e)
            if layout != "contiguous":
                want_lane = e
            out = torch.empty((1, d), device=cuda, dtype=dtype)
            assert cuda_kernels.rows_lane_bytes(tab, out) == want_lane, (d, layout)
            batch = torch.randperm(R, generator=g, device=cuda)[:300]
            cases = [(batch, 0), (torch.cat([batch, torch.tensor([R, -1, R + 5], device=cuda)]), 0)]
            cases += [(_segment_ids(g, n, ng, k if not out_ else 5, out_, cuda).reshape(-1),
                       k if not out_ else 5) for out_ in (False, True)]
            for ids, per in cases:
                ids = ids.to(index_dtype)
                before = (cuda_kernels.gather_rows.launches, cuda_kernels.scatter_rows.launches)
                got = cuda_kernels.gather_rows(tab, ids, per, ng)
                assert _same_row_bits(got, gather.gather_rows_plain(tab, ids, per, ng)), (d, layout, per)
                src = torch.randn(got.shape, generator=g, device=cuda).to(dtype)
                back = cuda_kernels.scatter_rows(src, ids, R, per, ng)
                assert _same_row_bits(back, gather.scatter_rows_plain(src, ids, R, per, ng)), (
                    d, layout, per)
                assert (cuda_kernels.gather_rows.launches - before[0],
                        cuda_kernels.scatter_rows.launches - before[1]) == (1, 1)
    # Segments at and past the scatter's shared-memory map.
    for seg, route in ((12288, "segments"), (12289, "fill")):
        assert cuda_kernels.scatter_rows_route(7, seg) == route
        for d in (6, 48):
            tab = torch.randn((2 * seg, d), generator=g, device=cuda).to(dtype)
            ids = torch.stack([torch.randperm(seg - 1, generator=g, device=cuda)[:7]
                               for _ in range(2)])  # -1 below is the only seg - 1
            ids[0, 0], ids[1, 1] = -1, seg
            ids = ids.reshape(-1).to(index_dtype)
            got = cuda_kernels.gather_rows(tab, ids, 7, seg)
            assert _same_row_bits(got, gather.gather_rows_plain(tab, ids, 7, seg)), (seg, d)
            back = cuda_kernels.scatter_rows(got.nan_to_num(), ids, 2 * seg, 7, seg)
            assert _same_row_bits(back, gather.scatter_rows_plain(got.nan_to_num(), ids, 2 * seg, 7,
                                                              seg)), (seg, d)
    bad = torch.tensor([0, R, -1], device=cuda).to(index_dtype)
    out = cuda_kernels.scatter_rows(torch.ones((3, 48), device=cuda, dtype=dtype), bad, R)
    assert int((out != 0).sum()) == 48 and bool((out[0] == 1).all())
    idx = _segment_ids(g, n, ng, k, False, cuda)
    x = torch.randn((n, ng * 8, 6), generator=g, device=cuda).to(dtype).requires_grad_(True)
    sel = gather.gather_group_rows(x, idx, 8)
    cot = torch.randn(sel.shape, generator=g, device=cuda).to(dtype)
    sel.backward(cot)
    xc = x.detach().cpu().requires_grad_(True)
    want = gather.gather_group_rows(xc, idx.cpu(), 8)
    want.backward(cot.cpu())
    assert torch.equal(sel.detach().cpu(), want.detach()) and torch.equal(x.grad.cpu(), xc.grad)
    tab = torch.zeros((R, 48), device=cuda, dtype=dtype)
    flat = idx.reshape(-1).to(index_dtype)
    with pytest.raises(ValueError):
        cuda_kernels.scatter_rows(tab[: n * k].double(), flat, R)
    with pytest.raises(ValueError):
        cuda_kernels.scatter_rows(tab[: n * k], flat[1:], R)
    with pytest.raises(ValueError):
        cuda_kernels.gather_rows(tab, flat, -1, ng)
    with pytest.raises(ValueError):
        cuda_kernels.gather_rows(tab, flat, k, 0)
    for name, fp in cuda_kernels.rows_footprint().items():
        assert fp["blocks_per_sm"] >= 1 and fp["local_bytes"] == 0, (name, fp)


def test_lpips_on_the_card_matches_its_cpu_forward(cuda, tmp_path, monkeypatch):
    """LPIPS alex and vgg (random weights, `utils/lpips.py:random_weights`)
    on the card against the same forward on the CPU, rtol 1e-4 (cuDNN's
    float32 convolutions sum in another order; TF32 is off)."""
    import numpy as np

    from ngf_tpu_torch.utils import lpips

    for seed, net in enumerate(("alex", "vgg")):
        np.savez(tmp_path / f"lpips_{net}.npz",
                 **lpips.random_weights(net, np.random.default_rng(seed)))
    monkeypatch.setenv("NGF_LPIPS_WEIGHTS_DIR", str(tmp_path))
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (96, 112, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    for net in ("alex", "vgg"):
        got = lpips.rgb_lpips(a, b, net, device=cuda)
        want = lpips.rgb_lpips(a, b, net, device="cpu")
        assert got > 0 and abs(got - want) <= 1e-4 * abs(want), (net, got, want)
    assert torch.backends.cudnn.allow_tf32  # restored after the forward
    lpips._models.clear()


def test_export_mesh_chunk_launches_k1_and_matches_the_cpu(cuda, tmp_path):
    """The export's alpha chunk (``compute_alpha_grid_chunk``: 524,288
    lattice points, the density channels) is one K1 launch and equals the
    plain sampler's on the CPU; ``export_mesh`` at 256^3 makes 32 K1
    launches and no other."""
    from ngf_tpu_torch import convert
    from ngf_tpu_torch.config import TrainArgs
    from ngf_tpu_torch.data import load_dataset
    from ngf_tpu_torch.train.loop import TriPlaneTrainer
    from ngf_tpu_torch.train.occupancy import dense_grid_points

    datadir = "synthetic:views=2,wh=16,test_views=1"
    args = TrainArgs(dataset_name="synthetic", datadir=datadir, plane_res=64, nSamples=48,
                     batch_size=96, n_iters=2, device="cuda")
    trainer = TriPlaneTrainer(args, load_dataset("synthetic", datadir, split="train",
                                                 is_stack=False), device=cuda)
    with torch.no_grad():  # denser planes: part of the lattice above the level
        for n in ("plane_xy", "plane_yz", "plane_xz"):
            trainer.params[n].mul_(3000.0)
        [t for _, t in convert.named_leaves(trainer.params["density_decoder"])][-1].fill_(0.0)
    pts = dense_grid_points(trainer.aabb, (256, 256, 8), cuda).reshape(-1, 3)
    aabb = torch.as_tensor(trainer.aabb, device=cuda)
    before = cuda_kernels.bilinear_gather_planes.launches
    with torch.no_grad():
        got = tv.compute_alpha_grid_chunk(trainer.params, trainer.model_cfg, pts, aabb,
                                          trainer.step_size)
        cpu = convert.params_from_numpy(convert.params_to_numpy(trainer.params), "cpu")
        want = tv.compute_alpha_grid_chunk(cpu, trainer.model_cfg, pts.cpu(), aabb.cpu(),
                                           trainer.step_size)
    assert cuda_kernels.bilinear_gather_planes.launches == before + 1
    assert 0 < (want > 0.005).float().mean().item() < 1
    assert (got.cpu() - want).abs().max().item() <= 1e-5
    cuda_kernels.reset_launch_counts()
    rec = trainer.export_mesh(str(tmp_path / "mesh.ply"))
    launched = {k: fn.launches for k, fn in cuda_kernels.KERNELS.items() if fn.launches}
    assert launched == {"bilinear_gather_planes": 32}, launched
    assert rec["faces"] > 0 and (tmp_path / "mesh.ply").is_file()


def test_uv_ray_functions_on_the_card_match_the_cpu(cuda):
    """``cube_ray_generation_with_end``, ``sample_pdf`` and
    ``refine_cube_ray_generation`` on CUDA tensors against the same calls
    on CPU copies, within ``chip_smoke.uv_ray_bounds``: 1e-6 of each value,
    plus the move that float32 CDF rounding gives a draw; the masks equal
    but at the cube's face."""
    import chip_smoke
    from ngf_tpu_torch.ops import rays

    g = torch.Generator(device=cuda).manual_seed(3)
    b, r, s = 1, 576, 64
    campos = torch.tensor([[0.3, -0.2, 2.6]], device=cuda)
    target = torch.rand((b, r, 3), generator=g, device=cuda) - 0.5
    d = torch.nn.functional.normalize(target - campos[:, None], dim=-1)
    end = campos[:, None] + d * (1.5 + 2.0 * torch.rand((b, r, 1), generator=g, device=cuda))
    u = torch.rand((b, r, s), generator=g, device=cuda)
    prev_ts = torch.sort(1.0 + 3.0 * torch.rand((b, r, s), generator=g, device=cuda)).values
    prev_w = torch.rand((b, r, s), generator=g, device=cuda)
    u2 = torch.rand((b, r, s + 1), generator=g, device=cuda)
    calls = {
        "with_end": lambda t: rays.cube_ray_generation_with_end(
            t["campos"], t["d"], t["end"], s, 1.0, 0.5, t["u"]),
        "sample_pdf": lambda t: (rays.sample_pdf(t["bins"], t["w"], s + 1, u=t["u2"]),),
        "refine": lambda t: rays.refine_cube_ray_generation(
            t["campos"], t["d"], s, t["prev_ts"], t["prev_w"], 1.0, False, u=t["u2"]),
    }
    inputs = {"campos": campos, "d": d, "end": end, "u": u, "prev_ts": prev_ts, "prev_w": prev_w,
              "u2": u2, "bins": 0.5 * (prev_ts[..., 1:] + prev_ts[..., :-1]),
              "w": prev_w[..., 1:-1]}
    cpu = {k: v.cpu() for k, v in inputs.items()}
    for name, fn in calls.items():
        got = fn(inputs)
        want = fn(cpu)
        draws = None if name == "with_end" else (cpu["bins"], cpu["w"], cpu["u2"])
        bounds = chip_smoke.uv_ray_bounds(want, draws, refined=name == "refine")
        for a, w, bound in zip(got, want, bounds):
            assert a.device.type == "cuda", name
            if w.dtype == torch.bool:
                assert torch.equal(a.cpu()[bound], w[bound]), name
            else:
                assert ((a.cpu() - w).abs() <= bound).all(), name
