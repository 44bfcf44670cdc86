"""The port's trainer against the JAX train step on the CPU: 12 steps from
identical weights (carried across with `ngf_tpu_torch.convert`) on identical
batches, without jitter, for InfoInv on and off; and six steps continued
from a JAX optimizer state carried across with
`convert.load_optimizer_state`. Kept apart from `tests/test_torch_train.py`
so that the test runner can give the two files to two workers.

Tolerances: the loss to rtol 2e-3 / atol 2e-5 at every step, as
`tests/test_training_parity.py` holds JAX to its torch oracle; the final
planes to PLANE_TOL = 1e-3, 5% of one step at lr 0.02, since Adam turns
gradients at the rounding level into steps of up to the learning rate.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from test_torch_train import N_ITERS, _args, _trainer  # noqa: E402

from ngf_tpu.data.sampler import SimpleSampler as JSampler  # noqa: E402
from ngf_tpu.fields import triplane as jt  # noqa: E402
from ngf_tpu.render import volume as jv  # noqa: E402
from ngf_tpu.train import occupancy as j_occ  # noqa: E402
from ngf_tpu.train.state import make_optimizer, triplane_lr_tree  # noqa: E402
from ngf_tpu_torch import convert  # noqa: E402
from ngf_tpu_torch.train.loop import TriPlaneTrainer  # noqa: E402

PLANE_TOL = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes here are too small to gain from
    more, and the test runner's parallel workers would oversubscribe the
    cores with a full thread pool each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_setup(trainer, seed):
    """Identical starting weights for both sides (density bias raised so the
    scene is partly opaque), the JAX render config of the trainer's
    geometry, and the JAX step of `tests/test_training_parity.py:179-188`."""
    jcfg = jt.TriPlaneConfig(**dataclasses.asdict(trainer.model_cfg))
    params = jax.device_get(jt.init_triplane(jax.random.PRNGKey(seed), jcfg))
    params["density_decoder"]["mlp"]["layers"][-1]["b"] = np.full((1,), 6.0, np.float32)
    r = trainer._render_cfg()
    rcfg = jv.RenderConfig(
        aabb=r.aabb, near=r.near, far=r.far, n_samples=r.n_samples, step_size=r.step_size,
        distance_scale=r.distance_scale, ray_march_weight_thres=r.ray_march_weight_thres,
        white_bg=r.white_bg, sample_cap=r.sample_cap, group_size=0,
    )
    a = trainer.args
    optimizer = make_optimizer(triplane_lr_tree(params, a.lr_init, a.lr_basis), 0.1, a.n_iters)
    l1_w = trainer.l1_weight

    # Not jitted: XLA's fused CPU loops contract o + d * t into one FMA,
    # which moves the first sample of a ray, exactly on the AABB face, in or
    # out of the box (an rgb change of ~1e-2 for the ray). Eager JAX rounds
    # as PyTorch does.
    def train_step(p, s, rays, rgbs):
        def loss_fn(p):
            out = jv.render_rays(p, jcfg, rcfg, rays, None, is_train=False)
            mse = jnp.mean((out["rgb_map"] - rgbs) ** 2)
            return mse + l1_w * jt.density_l1(p), mse

        (_, mse), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, s = optimizer.update(grads, s, p)
        return optax.apply_updates(p, updates), s, mse

    return params, optimizer, train_step


@pytest.mark.parametrize("infoinv", [True, False], ids=["infoinv", "plain_pe"])
def test_trajectory_matches_jax_train_step(infoinv):
    """12 steps of the port's trainer (its sampler, row gather, loss,
    backward and optimizer; no jitter) against the JAX step on the same
    batches from identical weights."""
    probe, ds = _trainer(infoinv)
    params, optimizer, train_step = _jax_setup(probe, seed=3)
    trainer = TriPlaneTrainer(_args(infoinv), ds, init_params=convert.params_from_numpy(params, "cpu"),
                              device="cpu")
    rays_all = np.asarray(ds.all_rays, np.float32)
    rgbs_all = np.asarray(ds.all_rgbs, np.float32)
    keep = j_occ.filter_rays_bbox(rays_all, trainer.aabb)
    np.testing.assert_array_equal(trainer.all_rays.numpy(), rays_all[keep])
    sampler = JSampler(int(keep.sum()), 96, trainer.args.seed)
    state = optimizer.init(params)

    ours, theirs = [], []
    for _ in range(N_ITERS):
        ids = sampler.nextids()
        params, state, mse = train_step(params, state, jnp.asarray(rays_all[keep][ids]),
                                        jnp.asarray(rgbs_all[keep][ids]))
        theirs.append(float(mse))
        rays, rgbs = trainer.next_batch()
        np.testing.assert_array_equal(rgbs.numpy(), rgbs_all[keep][ids])
        ours.append(float(trainer.train_step(rays, rgbs)))
    np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=2e-5)
    assert np.abs(np.diff(theirs)).max() > 1e-4  # the weights moved the loss
    for name in ("plane_xy", "plane_yz", "plane_xz"):
        np.testing.assert_allclose(trainer.params[name].detach().numpy(), np.asarray(params[name]),
                                   atol=PLANE_TOL, rtol=0, err_msg=name)


def test_step_from_carried_jax_optimizer_state():
    """Six JAX steps, then the weights and the optax state carried into the
    port (`convert.load_optimizer_state`): the next six steps agree."""
    probe, ds = _trainer(True)
    params, optimizer, train_step = _jax_setup(probe, seed=5)
    state = optimizer.init(params)
    rng = np.random.default_rng(12)
    rays_all = np.asarray(ds.all_rays, np.float32)
    rgbs_all = np.asarray(ds.all_rgbs, np.float32)
    batches = [rng.choice(rays_all.shape[0], 96, replace=False) for _ in range(N_ITERS)]
    for ids in batches[:6]:
        params, state, _ = train_step(params, state, jnp.asarray(rays_all[ids]), jnp.asarray(rgbs_all[ids]))
    trainer = TriPlaneTrainer(_args(True), ds, init_params=convert.params_from_numpy(
        jax.device_get(params), "cpu"), device="cpu")
    adam, sched = jax.device_get(state[0]), jax.device_get(state[1])
    convert.load_optimizer_state(trainer.optimizer, adam.mu, adam.nu, adam.count, sched["count"])
    assert trainer.optimizer.count == 6
    ours, theirs = [], []
    for ids in batches[6:]:
        params, state, mse = train_step(params, state, jnp.asarray(rays_all[ids]), jnp.asarray(rgbs_all[ids]))
        theirs.append(float(mse))
        ours.append(float(trainer.train_step(torch.from_numpy(rays_all[ids]),
                                             torch.from_numpy(rgbs_all[ids]))))
    np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(trainer.params["plane_xy"].detach().numpy(),
                               np.asarray(params["plane_xy"]), atol=PLANE_TOL, rtol=0)
