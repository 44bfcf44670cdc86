"""A tiny staged learned-gauge run of the port's trainer against the JAX
trainer (`ngf_tpu/train/loop.py:TriPlaneTrainer`) on the CPU, as
`tests/test_torch_staged_parity.py` does for InfoInv: the recipe of
`configs/synthetic_triplane_tpu.txt` (grouped, G = 8) at small widths, the
gauge switched on at step 2, the mask event with the shrink at 4 and the
upsample two steps later, from identical weights, on the same batches with
the same per-ray jitter (drawn from the JAX trainer's keys and handed to the
port's draw). The events run under ``jax.disable_jit()``, op by op, as in
that file; the train steps run compiled. The planes' density is high only
where the windows of all three planes meet, so that the event finds a part
of the lattice occupied and the shrink crops the planes.

Checked exactly: after the mask event the box, grid size, step, sample
count, mask volume, kept rays and measured capacity; after the upsample the
grid size, step, sample count, plane shapes and the capacity measured again.
The loss at every step to rtol 2e-3 / atol 2e-5, as
`tests/test_training_parity.py` holds JAX to its torch oracle.
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_torch_staged_parity import _step_jitter  # noqa: E402

from ngf_tpu.config import config_parser as j_config_parser  # noqa: E402
from ngf_tpu.data import registry as j_registry  # noqa: E402
from ngf_tpu.fields import triplane as jt  # noqa: E402
from ngf_tpu.train.loop import TriPlaneTrainer as JTrainer  # noqa: E402
from ngf_tpu_torch import convert  # noqa: E402
from ngf_tpu_torch.config import config_parser as t_config_parser  # noqa: E402
from ngf_tpu_torch.data import load_dataset  # noqa: E402
from ngf_tpu_torch.render import volume as tv  # noqa: E402
from ngf_tpu_torch.train.loop import TriPlaneTrainer  # noqa: E402

DATADIR = "synthetic:views=2,wh=16,test_views=1"
N_ITERS, GAUGE, MASK, UPSAMPLE = 8, 2, 4, 6
ARGV = [
    "--config", os.path.join(REPO, "configs", "synthetic_triplane_tpu.txt"), "--datadir", DATADIR,
    "--plane_res", "32", "--gauge_res", "16", "--nSamples", "96", "--batch_size", "64",
    "--open_sample_cap", "32", "--alpha_grid_res", "12", "--n_iters", str(N_ITERS),
    "--gauge_start", str(GAUGE), "--update_AlphaMask_list", str(MASK),
    "--upsamp_list", str(UPSAMPLE), "--N_voxel_init", str(24 ** 3), "--prewarm_events", "0",
    "--eval_chunk", "64",
]
PLANES = ("plane_xy", "plane_yz", "plane_xz")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _geometry(trainer):
    return (np.asarray(trainer.aabb, np.float32).tolist(), list(trainer.grid_size),
            trainer.step_size, trainer.n_samples)


def test_staged_gauge_run_matches_jax_trainer(monkeypatch):
    jargs = j_config_parser(ARGV)
    targs = t_config_parser(ARGV + ["--device", "cpu"])
    assert targs.subsystem == "triplane" and targs.group_size == 8 and targs.sample_cap == -1
    jds = j_registry.load_dataset("synthetic", DATADIR, split="train", is_stack=False)
    tds = load_dataset("synthetic", DATADIR, split="train", is_stack=False)

    ours = TriPlaneTrainer(targs, tds, device="cpu")
    jcfg = jt.TriPlaneConfig(**{k: getattr(ours.model_cfg, k)
                                for k in jt.TriPlaneConfig.__dataclass_fields__})
    params = jax.device_get(jt.init_triplane(jax.random.PRNGKey(3), jcfg))
    # Density channels +3 inside a window of each plane and -3 outside it,
    # summed by a density head of equal weights: softplus(3 * 3 - 10) inside
    # all three windows clears the mask threshold, softplus(3 - 10) does
    # not. The occupied voxels' box, and with it the shrink, is smaller than
    # the field's.
    dd = jcfg.density_dim
    window = np.full((32, 32), -3.0, np.float32)
    window[6:22, 9:26] = 3.0
    for name in PLANES:
        params[name] = params[name].copy()
        params[name][..., :dd] += window[..., None]
    params["density_decoder"]["w"] = np.full((3 * dd, 1), 1.0 / dd, np.float32)
    ours = TriPlaneTrainer(targs, tds, init_params=convert.params_from_numpy(params, "cpu"),
                           device="cpu")
    with jax.disable_jit():
        theirs = JTrainer(jargs, jds, init_params=jax.tree.map(jnp.asarray, params))
    # The config's upsample at 800 stays (a CLI list flag appends), past N_ITERS.
    assert ours.n_voxel_list == theirs.n_voxel_list and ours.n_voxel_list[0] == 24 ** 3
    np.testing.assert_array_equal(ours.all_rays.numpy(), theirs.all_rays)
    gen = torch.Generator()  # a training render; the jitter comes from JAX

    losses_j, losses_t = [], []
    for _ in range(N_ITERS):
        jitter = _step_jitter(theirs)
        monkeypatch.setattr(tv, "_ray_jitter", lambda g, n, device: torch.from_numpy(jitter))
        losses_j.append(float(theirs.train_block(1)[0]))
        losses_t.append(float(ours.train_step(*ours.next_batch(), gen)))
        if ours.iteration == MASK:
            before = _geometry(ours)
            with jax.disable_jit():
                theirs._event_update_alpha_mask(first=True)
            rec = ours._event_update_alpha_mask(first=True)
            np.testing.assert_array_equal(ours.alpha.volume.numpy(), np.asarray(theirs.alpha.volume))
            assert 0 < rec["voxels"] < 12 ** 3
            # The shrink: a smaller box, the grid and step from it, n_samples kept.
            assert _geometry(ours) == _geometry(theirs)
            assert ours.aabb.tolist() != before[0] and ours.n_samples == before[3]
            assert rec["shrink"]["grid_size"] == theirs.grid_size
            for name in PLANES:
                assert tuple(ours.params[name].shape) == np.asarray(theirs.params[name]).shape
                # The same crop of weights that four steps moved apart by rounding.
                np.testing.assert_allclose(ours.params[name].detach().numpy(),
                                           np.asarray(theirs.params[name]), rtol=2e-3, atol=1e-4)
            assert 0 < rec["rays_kept"] < rec["rays_before"]
            np.testing.assert_array_equal(ours.all_rays.numpy(), theirs.all_rays)
            assert ours._auto_cap == theirs._auto_cap
            assert ours._effective_sample_cap() == theirs._effective_sample_cap()
            assert ours.l1_weight == theirs.l1_weight == targs.L1_weight_rest
        if ours.iteration == UPSAMPLE:
            with jax.disable_jit():
                theirs._event_upsample()
            rec = ours._event_upsample()
            assert ours.reso_cur == list(theirs.reso_cur)
            assert _geometry(ours) == _geometry(theirs)
            assert rec["plane_shapes"] == [list(np.asarray(theirs.params[n]).shape) for n in PLANES]
            assert ours._auto_cap == theirs._auto_cap
            assert rec["capg"] == -(-ours._auto_cap // 8)
            assert ours.optimizer.count == 0
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-3, atol=2e-5)
    assert np.abs(np.diff(losses_j)).max() > 1e-4
    # The gauge learned something after GAUGE, in both.
    for name in ("gauge_xy", "gauge_yz", "gauge_xz"):
        assert np.abs(np.asarray(theirs.params[name])).max() > 0
        np.testing.assert_allclose(ours.params[name].detach().numpy(),
                                   np.asarray(theirs.params[name]), rtol=2e-3, atol=1e-6)
