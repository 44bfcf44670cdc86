"""A tiny staged InfoInv run of the port's trainer against the JAX trainer
(`ngf_tpu/train/loop.py:TriPlaneTrainer`) run eagerly on the CPU: six
grouped steps (G = 8) with the mask event after the third, or a first
event after the second step and a later one after the fourth (the 30k
schedule's later events: the grid pre-culled by the previous one, no ray
refilter, the capacity measured again), from identical weights, on the
same batches with the same per-ray jitter.

Before each JAX step the test draws the jitter that step's key gives
(`ngf_tpu/ops/rays.py:89-90`) and hands it to the port's draw. The JAX train
steps run compiled, as the trainer runs them: with a jitter no sample lies
on the box's faces, where XLA's CPU FMA of ``o + d * t`` would move it in
or out (`tests/test_torch_train_parity.py`). The event and the evaluation,
which march without jitter from the entry face, run under
``jax.disable_jit()``, op by op. The weights start from the JAX initialisation with the
planes 300 times their scale and the density bias at 0, so that the event
finds part of the lattice occupied and drops some of the rays.

Checked: each event's mask volume, its box, the kept-ray mask, the sampler's
ids after a first event, the previous grid a later event pre-culls with,
the measured capacity and the L1 switch, exactly; the loss at
every step to rtol 2e-3 / atol 2e-5, as `tests/test_training_parity.py`
holds JAX to its torch oracle; the post-event evaluation renderer's rgb and
depth to 1e-4.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ngf_tpu.config import config_parser as j_config_parser  # noqa: E402
from ngf_tpu.data import registry as j_registry  # noqa: E402
from ngf_tpu.fields import triplane as jt  # noqa: E402
from ngf_tpu.train.loop import TriPlaneTrainer as JTrainer  # noqa: E402
from ngf_tpu_torch import convert  # noqa: E402
from ngf_tpu_torch.config import config_parser as t_config_parser  # noqa: E402
from ngf_tpu_torch.data import load_dataset  # noqa: E402
from ngf_tpu_torch.render import volume as tv  # noqa: E402
from ngf_tpu_torch.train.loop import TriPlaneTrainer, model_config_from_args  # noqa: E402

DATADIR = "synthetic:views=2,wh=16,test_views=1"
N_ITERS = 6
ARGV = [
    "--config", os.path.join(REPO, "configs", "synthetic_infoinv_tpu.txt"), "--datadir", DATADIR,
    "--plane_res", "32", "--nSamples", "96", "--batch_size", "64", "--open_sample_cap", "32",
    "--alpha_grid_res", "12", "--n_iters", str(N_ITERS), "--prewarm_events", "0",
    "--eval_chunk", "64",
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step_jitter(jtrainer) -> np.ndarray:
    """The (B, 1) jitter of the JAX trainer's next one-step block
    (`train_block`: split the key, one key a step; `render_rays`: split
    into the jitter's and the background's)."""
    _, sub = jax.random.split(jtrainer.key)
    k_jit, _ = jax.random.split(jax.random.split(sub, 1)[0])
    return np.array(jax.random.uniform(k_jit, (jtrainer.args.batch_size, 1), dtype=jnp.float32))


@pytest.mark.parametrize("events", [(3,), (2, 4)], ids=["one_event", "later_event"])
def test_staged_run_matches_jax_trainer(monkeypatch, events):
    argv = ARGV + [a for e in events for a in ("--update_AlphaMask_list", str(e))]
    jargs = j_config_parser(argv)
    targs = t_config_parser(argv + ["--device", "cpu"])
    assert targs.group_size == 8 and targs.sample_cap == -1
    assert [e for e in targs.update_AlphaMask_list if e <= N_ITERS] == list(events)
    jds = j_registry.load_dataset("synthetic", DATADIR, split="train", is_stack=False)
    tds = load_dataset("synthetic", DATADIR, split="train", is_stack=False)
    test_ds = load_dataset("synthetic", DATADIR, split="test", is_stack=True)

    cfg = jt.TriPlaneConfig(**dataclasses.asdict(model_config_from_args(targs)))
    params = jax.device_get(jt.init_triplane(jax.random.PRNGKey(3), cfg))
    for name in ("plane_xy", "plane_yz", "plane_xz"):
        params[name] = params[name] * np.float32(300.0)
    params["density_decoder"]["mlp"]["layers"][-1]["b"] = np.full((1,), 0.0, np.float32)

    ours = TriPlaneTrainer(targs, tds, init_params=convert.params_from_numpy(params, "cpu"),
                           device="cpu")
    with jax.disable_jit():
        theirs = JTrainer(jargs, jds, init_params=jax.tree.map(jnp.asarray, params))
    np.testing.assert_array_equal(ours.all_rays.numpy(), theirs.all_rays)
    gen = torch.Generator()  # a training render; the jitter comes from JAX

    losses_j, losses_t = [], []
    for _ in range(N_ITERS):
        jitter = _step_jitter(theirs)
        monkeypatch.setattr(tv, "_ray_jitter", lambda g, n, device: torch.from_numpy(jitter))
        losses_j.append(float(theirs.train_block(1)[0]))
        rays, rgbs = ours.next_batch()
        losses_t.append(float(ours.train_step(rays, rgbs, gen)))
        if ours.iteration in events:
            first = ours.iteration == events[0]
            before = ours.all_rays.clone()
            prev = None if first else ours.alpha.volume.clone()
            if prev is not None:  # the grid both start the later event from
                np.testing.assert_array_equal(prev.numpy(), np.asarray(theirs.alpha.volume))
            with jax.disable_jit():
                theirs._event_update_alpha_mask(first=first)
            rec = ours._event_update_alpha_mask(first=first)
            np.testing.assert_array_equal(ours.alpha.volume.numpy(), np.asarray(theirs.alpha.volume))
            np.testing.assert_array_equal(ours.alpha.aabb.numpy(), np.asarray(theirs.alpha.aabb))
            assert 0 < rec["voxels"] < 12 ** 3 and rec["first"] == first
            # The kept rays, in order: the JAX trainer's ray set after its
            # filter; a later event keeps the set.
            assert rec["rays_before"] == before.shape[0]
            assert (0 < rec["rays_kept"] < rec["rays_before"]) if first else (
                rec["rays_kept"] == rec["rays_before"] and not rec["refiltered"])
            np.testing.assert_array_equal(ours.all_rays.numpy(), theirs.all_rays)
            np.testing.assert_array_equal(ours.all_rgbs.numpy(), theirs.all_rgbs)
            assert ours._auto_cap == theirs._auto_cap and ours._auto_cap < targs.nSamples
            assert ours._effective_sample_cap() == theirs._effective_sample_cap()
            assert rec["capg"] == -(-ours._auto_cap // 8)
            assert ours.l1_weight == theirs.l1_weight == targs.L1_weight_rest
            if first:
                # The new sampler's first ids, from the same seed.
                np.testing.assert_array_equal(ours.sampler.nextids().numpy(),
                                              theirs.sampler.nextids())
                ours.sampler._curr -= ours.sampler.batch
                theirs.sampler._curr -= theirs.sampler.batch
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-3, atol=2e-5)
    assert np.abs(np.diff(losses_j)).max() > 1e-4
    assert int(ours.rgb_stat) == theirs._rgb_stat

    # The post-event evaluation renderer (grouped, with the mask).
    rays = np.asarray(test_ds.all_rays[0]).reshape(-1, 6)[:128]
    with jax.disable_jit():
        j_rgb, j_depth = theirs.make_eval_render_fn(iteration=N_ITERS)(jnp.asarray(rays))
    t_rgb, t_depth = ours.make_eval_render_fn(iteration=N_ITERS)(torch.from_numpy(rays))
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_depth.numpy(), np.asarray(j_depth), rtol=1e-4, atol=1e-4)
