"""The port's batch assembly against the JAX package on the CPU: the device
sampler and the one-gather batch of ``TriPlaneTrainer.next_batch`` against
`ngf_tpu`'s ``_next_block`` (`ngf_tpu/train/loop.py:1438-1451`) and
sampler; with them the small pieces of the same change that the CPU can
check: the backward kernel's choice of float4 or scalar lanes, the cached
AABB tensor and the initialisers' device.

Sizes are small (a 2-view 16 x 16 synthetic scene). Ids and gathered rows
are copies, so every comparison is exact.
"""

import dataclasses
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from ngf_tpu.data.sampler import SimpleSampler as JSampler  # noqa: E402
from ngf_tpu.train import occupancy as j_occ  # noqa: E402
from ngf_tpu.train.loop import TriPlaneTrainer as JTrainer  # noqa: E402
from ngf_tpu_torch.config import TrainArgs  # noqa: E402
from ngf_tpu_torch.convert import named_leaves  # noqa: E402
from ngf_tpu_torch.data import load_dataset  # noqa: E402
from ngf_tpu_torch.data.sampler import DeviceSampler, SimpleSampler  # noqa: E402
from ngf_tpu_torch.fields import decoders as td  # noqa: E402
from ngf_tpu_torch.fields import triplane as tt  # noqa: E402
from ngf_tpu_torch.ops import cuda_kernels  # noqa: E402
from ngf_tpu_torch.ops.gather import gather_rows_plain  # noqa: E402
from ngf_tpu_torch.render.volume import RenderConfig  # noqa: E402
from ngf_tpu_torch.train.loop import TriPlaneTrainer  # noqa: E402

DATADIR = "synthetic:views=2,wh=16,test_views=1"


@pytest.fixture(scope="module")
def dataset():
    return load_dataset("synthetic", DATADIR, split="train", is_stack=False)


def _trainer(ds, batch_size):
    args = TrainArgs(
        dataset_name="synthetic", datadir=DATADIR, subsystem="infoinv", infoinv=True,
        plane_res=32, gauge_res=32, nSamples=48, step_ratio=1.0, batch_size=batch_size,
        n_iters=12, group_size=0, device="cpu",
    )
    return TriPlaneTrainer(args, ds, device="cpu")


def _jax_blocks(ds, trainer, batch_size):
    """``ngf_tpu``'s ``_next_block`` on the same filtered training set and
    seed: one (rays, rgbs) pair per call."""
    rays = np.asarray(ds.all_rays, np.float32)
    rgbs = np.asarray(ds.all_rgbs, np.float32)
    keep = j_occ.filter_rays_bbox(rays, trainer.aabb)
    host = SimpleNamespace(
        args=SimpleNamespace(batch_size=batch_size), all_rays=rays[keep], all_rgbs=rgbs[keep],
        sampler=JSampler(int(keep.sum()), batch_size, trainer.args.seed),
    )
    while True:
        block_rays, block_rgbs = JTrainer._next_block(host, 1)
        yield block_rays[0], block_rgbs[0]


@pytest.mark.parametrize("case", ["epochs", "tile", "plain_gather"])
def test_batch_matches_jax_next_block(dataset, case):
    """``epochs``: 96-ray batches over more than two epochs of the filtered
    set, across each reshuffle. ``tile``: a batch larger than the set, which
    the sampler tiles. ``plain_gather``: the one gather of the (N, 9) table
    is ``all_rays[ids]`` and ``all_rgbs[ids]``."""
    if case == "plain_gather":
        trainer = _trainer(dataset, 96)
        rays = np.asarray(trainer.all_rays)
        rgbs = np.asarray(trainer.all_rgbs)
        for _ in range(3):
            ids = trainer.sampler.nextids()
            rows = gather_rows_plain(trainer.batch_table, ids)
            np.testing.assert_array_equal(rows[:, :6].numpy(), rays[ids.numpy()])
            np.testing.assert_array_equal(rows[:, 6:].numpy(), rgbs[ids.numpy()])
        return
    probe = _trainer(dataset, 96)
    total = probe.batch_table.shape[0]
    batch, calls = (96, 2 * (total // 96) + 3) if case == "epochs" else (2 * total + 7, 3)
    trainer = _trainer(dataset, batch)
    assert (batch < total) == (case == "epochs")
    theirs = _jax_blocks(dataset, trainer, batch)
    for _ in range(calls):
        rays, rgbs = trainer.next_batch()
        want_rays, want_rgbs = next(theirs)
        assert rays.shape == (batch, 6) and rgbs.shape == (batch, 3)
        np.testing.assert_array_equal(rays.numpy(), want_rays)
        np.testing.assert_array_equal(rgbs.numpy(), want_rgbs)
    epochs = -(-calls // (total // batch)) if case == "epochs" else calls
    assert trainer.sampler.uploads == epochs


@pytest.mark.parametrize("total,batch,seed", [(1000, 96, 20211202), (96, 96, 1), (50, 96, 3),
                                              (1, 7, 4)])
def test_device_sampler_ids_match_jax(total, batch, seed):
    """The device sampler gives the numpy sampler's ids, one upload per
    epoch (every call when the set is smaller than a batch)."""
    ours, theirs = DeviceSampler(total, batch, seed), JSampler(total, batch, seed)
    numpy_copy = SimpleSampler(total, batch, seed)
    for _ in range(25):
        got = ours.nextids()
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        want = theirs.nextids()
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(numpy_copy.nextids(), want)
    per_epoch = total // batch
    assert ours.uploads == (-(-25 // per_epoch) if per_epoch else 25)


_ALIGNED = 1 << 20


@pytest.mark.parametrize(
    "C,offset,texel_stride,g_stride,g_ptr,dst_ptr,lanes",
    [
        (72, 24, 96, 72, _ALIGNED, _ALIGNED + 4 * 24, 4),  # appearance fetch
        (24, 0, 96, 24, _ALIGNED, _ALIGNED, 4),  # density fetch
        (48, 16, 64, 48, _ALIGNED, _ALIGNED + 4 * 16, 4),  # gauge preset
        (72, 24, 96, 100, _ALIGNED + 32, _ALIGNED + 4 * 24, 4),  # strided g, aligned
        (10, 3, 96, 10, _ALIGNED, _ALIGNED + 4 * 3, 1),  # C and offset not multiples of 4
        (72, 24, 98, 72, _ALIGNED, _ALIGNED + 4 * 24, 1),  # texel stride
        (72, 24, 96, 73, _ALIGNED, _ALIGNED + 4 * 24, 1),  # g's row stride
        (72, 24, 96, 72, _ALIGNED + 4, _ALIGNED + 4 * 24, 1),  # g's base pointer
    ],
)
def test_backward_lanes(C, offset, texel_stride, g_stride, g_ptr, dst_ptr, lanes):
    """The backward kernel takes float4 loads and atomics only where every
    one of them is 16-byte aligned, and scalar ones otherwise."""
    assert cuda_kernels.backward_lanes(C, offset, texel_stride, g_stride, g_ptr, dst_ptr) == lanes


def test_aabb_tensor_is_one_copy_usable_for_training():
    """A render made under inference mode first caches a box that a
    training render can still use in autograd."""
    rcfg = RenderConfig(aabb=((-1.25,) * 3, (1.25,) * 3))
    with torch.inference_mode():
        first = rcfg.aabb_tensor("cpu")
    assert not first.is_inference()
    assert RenderConfig(aabb=rcfg.aabb).aabb_tensor(torch.device("cpu")) is first
    x = torch.ones(3, requires_grad=True)
    ((x - first[0]) * first[1]).sum().backward()
    torch.testing.assert_close(x.grad, first[1])


@pytest.mark.parametrize("variant", ["infoinv", "gauge"])
def test_initialisers_follow_the_generator_device(variant):
    """With no device the initialisers use the generator's: a CPU generator
    gives CPU tensors with the values an explicit ``device="cpu"`` gives."""
    cfg = (tt.TriPlaneConfig.infoinv_preset(True) if variant == "infoinv"
           else tt.TriPlaneConfig.gauge_preset())
    cfg = dataclasses.replace(cfg, plane_res=8, gauge_res=4)
    got = tt.init_triplane(cfg, torch.Generator().manual_seed(5))
    want = tt.init_triplane(cfg, torch.Generator().manual_seed(5), "cpu")
    pairs = list(zip(named_leaves(got), named_leaves(want)))
    assert len(pairs) > 6
    for (name, a), (_, b) in pairs:
        assert a.device.type == "cpu" and torch.equal(a, b), name
    layer = td.init_linear(torch.Generator().manual_seed(1), 5, 3)
    assert layer["w"].device.type == "cpu" and layer["b"].shape == (3,)
