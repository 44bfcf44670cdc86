"""Training resume of the port's tri-plane trainer
(`ngf_tpu_torch/train/loop.py:TriPlaneTrainer.from_checkpoint`), held to the
contract of `tests/test_resume.py`:

- the port against itself on the CPU: a straight run and a run stopped at a
  checkpoint and resumed by a new trainer end with equal parameters,
  optimizer leaves, kept rays, ray table, sampler stream, occupancy grid
  and capacity, exactly; for InfoInv across mask events (the first, which
  refilters the rays, before the checkpoint and a later one after it), and
  for the learned gauge with its shrink and an upsample at the checkpoint
  iteration and a second upsample and the gauge's start after it;
- across packages, both ways: a JAX trainer's checkpoint restored by the
  port and a port checkpoint restored by `ngf_tpu`'s
  ``TriPlaneTrainer.from_checkpoint`` give equal state on both sides (the
  parameters, the optax leaves, the grid, the rays, the geometry, the caps,
  the voxel schedule and the sampler's next ids), and four teacher-forced
  steps after it (the same batches, the JAX step's jitter handed to the
  port, as `tests/test_torch_staged_parity.py` does) give losses within
  rtol 2e-3;
- SIGTERM from a progress callback: the run stops after that step with a
  checkpoint at its iteration, the previous handler is back, and a resume
  finishes;
- the rejections (a params-only checkpoint, another subsystem, an optimizer
  leaf of the wrong shape, ray ids past the dataset's rays) and the CLI (``main_torch.py --ckpt`` resumes;
  ``scalars.jsonl`` holds the JAX trainer's keys).
"""

import dataclasses
import json
import os
import signal
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
from ngf_tpu_torch.config import TrainArgs  # noqa: E402
from ngf_tpu_torch.config import config_parser as t_config_parser  # noqa: E402
from ngf_tpu_torch.data import load_dataset  # noqa: E402
from ngf_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from ngf_tpu_torch.fields.triplane import init_triplane  # noqa: E402
from ngf_tpu_torch.render import volume as tv  # noqa: E402
from ngf_tpu_torch.train.loop import TriPlaneTrainer, model_config_from_args  # noqa: E402
from ngf_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402

PLANES = ("plane_xy", "plane_yz", "plane_xz")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def resume_args(**kw) -> TrainArgs:
    """`tests/test_resume.py`'s ``resume_args`` on the port, the run cut to
    40 steps, with the staged recipe's measured capacity."""
    base = dict(
        subsystem="infoinv", dataset_name="synthetic", batch_size=256, n_iters=40, nSamples=64,
        vis_every=0, N_vis=0, save_every=24, upsamp_list=[], update_AlphaMask_list=[16, 32],
        # The decay horizon pinned: the run to the checkpoint has another n_iters.
        lr_decay_iters=40, seed=0, plane_res=32, gauge_res=32, alpha_grid_res=32,
        sample_cap=-1, open_sample_cap=32, device="cpu",
    )
    base.update(kw)
    return TrainArgs(**base)


@pytest.fixture(scope="module")
def datasets():
    return (make_synthetic_dataset("train", n_views=6, wh=(40, 40)),
            make_synthetic_dataset("test", n_views=2, wh=(40, 40)))


def init_params(args: TrainArgs, scale: float, bias: float):
    """Weights whose first mask event keeps part of the lattice: the planes
    ``scale`` times their initial scale, the density's last bias ``bias``."""
    p = init_triplane(model_config_from_args(args), torch.Generator().manual_seed(3), "cpu")
    for n in PLANES:
        p[n] = p[n] * scale
    b = [t for _, t in convert.named_leaves(p["density_decoder"])][-1]
    b.fill_(bias)
    return p


def assert_same_state(a: TriPlaneTrainer, b: TriPlaneTrainer) -> None:
    assert a.iteration == b.iteration
    names_a = [n for n, _ in convert.sorted_named_leaves(a.params)]
    assert names_a == [n for n, _ in convert.sorted_named_leaves(b.params)]
    for (n, x), (_, y) in zip(convert.sorted_named_leaves(a.params),
                              convert.sorted_named_leaves(b.params)):
        assert torch.equal(x, y), n
    la, lb = a.optimizer.to_optax_leaves(), b.optimizer.to_optax_leaves()
    assert len(la) == len(lb) == 2 * len(names_a) + 2
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)
    assert a.optimizer.count == b.optimizer.count
    np.testing.assert_array_equal(a._ray_ids, b._ray_ids)
    assert torch.equal(a.batch_table, b.batch_table)
    assert torch.equal(a.alpha.volume, b.alpha.volume) and torch.equal(a.alpha.occ, b.alpha.occ)
    assert a._effective_sample_cap() == b._effective_sample_cap()
    assert (a.grid_size, a.step_size, a.n_samples, a.n_voxel_list, a.l1_weight) == (
        b.grid_size, b.step_size, b.n_samples, b.n_voxel_list, b.l1_weight)
    np.testing.assert_array_equal(a.aabb, b.aabb)
    assert torch.equal(a.sampler.nextids(), b.sampler.nextids())


@pytest.mark.parametrize("case", ["infoinv", "gauge"])
def test_port_resume_is_exact(datasets, tmp_path, case):
    train_ds, test_ds = datasets
    if case == "infoinv":
        args, scale, bias = resume_args(), 300.0, -8.0
    else:
        # Shrink (the first mask event) and an upsample at the checkpoint
        # iteration; a second upsample and the gauge's start after it.
        args, scale, bias = resume_args(
            subsystem="triplane", update_AlphaMask_list=[24], upsamp_list=[24, 32], gauge_start=28,
            N_voxel_init=32 ** 3, N_voxel_final=40 ** 3), 300.0, -40.0
    params = init_params(args, scale, bias)
    straight = TriPlaneTrainer(args, train_ds, test_ds, str(tmp_path / "straight"),
                               init_params=params, device="cpu")
    out = straight.run()
    part = TriPlaneTrainer(dataclasses.replace(args, n_iters=args.save_every), train_ds, test_ds,
                           str(tmp_path / "part"), init_params=params, device="cpu")
    part.run()
    resumed = TriPlaneTrainer.from_checkpoint(str(tmp_path / "part" / "model.npz"), args, train_ds,
                                              test_ds, str(tmp_path / "resumed"), device="cpu")
    assert resumed.iteration == args.save_every
    assert torch.equal(resumed.gen.get_state(), part.gen.get_state())
    rest = resumed.run()
    assert not rest["preempted"] and len(rest["train_mses"]) == args.n_iters - args.save_every
    np.testing.assert_array_equal(rest["train_mses"], out["train_mses"][args.save_every:])
    assert_same_state(straight, resumed)
    assert torch.equal(straight.gen.get_state(), resumed.gen.get_state())
    first = straight.events[0]
    if case == "infoinv":
        # The first event refiltered before the checkpoint; the later one
        # after it ran once, as a later event.
        assert first["refiltered"] and 0 < first["rays_kept"] < first["rays_before"]
        assert [(e["iteration"], e["first"]) for e in resumed.events] == [(32, False)]
    else:
        assert [(e["kind"], e["iteration"]) for e in straight.events] == [
            ("mask", 24), ("upsample", 24), ("upsample", 32)]
        assert "shrink" in first and part.grid_size != straight.grid_size == resumed.grid_size
        assert [(e["kind"], e["iteration"]) for e in resumed.events] == [("upsample", 32)]


# ----------------------------------------------------------- across packages

DATADIR = "synthetic:views=2,wh=16,test_views=1"
ARGV = [
    "--config", os.path.join(REPO, "configs", "synthetic_infoinv_tpu.txt"), "--datadir", DATADIR,
    "--plane_res", "32", "--nSamples", "96", "--batch_size", "64", "--open_sample_cap", "32",
    "--alpha_grid_res", "12", "--n_iters", "12", "--lr_decay_iters", "12", "--prewarm_events", "0",
    "--eval_chunk", "64", "--update_AlphaMask_list", "2",
]


def _step_jitter(jtrainer) -> np.ndarray:
    """The (B, 1) jitter of the JAX trainer's next one-step block
    (`tests/test_torch_staged_parity.py`)."""
    _, sub = jax.random.split(jtrainer.key)
    k_jit, _ = jax.random.split(jax.random.split(sub, 1)[0])
    return np.array(jax.random.uniform(k_jit, (jtrainer.args.batch_size, 1), dtype=jnp.float32))


def _cross_setup():
    jargs = j_config_parser(ARGV)
    targs = t_config_parser(ARGV + ["--device", "cpu"])
    jds = j_registry.load_dataset("synthetic", DATADIR, split="train", is_stack=False)
    tds = load_dataset("synthetic", DATADIR, split="train", is_stack=False)
    cfg = jt.TriPlaneConfig(**dataclasses.asdict(model_config_from_args(targs)))
    params = jax.device_get(jt.init_triplane(jax.random.PRNGKey(3), cfg))
    for name in PLANES:
        params[name] = params[name] * np.float32(300.0)
    params["density_decoder"]["mlp"]["layers"][-1]["b"] = np.full((1,), 0.0, np.float32)
    return jargs, targs, jds, tds, params


def _assert_same_across(ours: TriPlaneTrainer, theirs) -> None:
    """The port's trainer and the JAX trainer hold the same state."""
    assert ours.iteration == theirs.iteration
    j_leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(theirs.params))[0]
    t_leaves = list(convert.sorted_named_leaves(ours.params))
    assert len(j_leaves) == len(t_leaves)
    for (_, jl), (name, tl) in zip(j_leaves, t_leaves):
        np.testing.assert_array_equal(tl.detach().numpy(), np.asarray(jl), err_msg=name)
    j_opt = [np.asarray(x) for x in jax.tree.leaves(theirs.opt_state)]
    t_opt = ours.optimizer.to_optax_leaves()
    assert len(j_opt) == len(t_opt) == 2 * len(t_leaves) + 2
    for x, y in zip(t_opt, j_opt):
        np.testing.assert_array_equal(x, y)
    assert int(j_opt[0]) == int(j_opt[-1]) == ours.optimizer.count > 0
    np.testing.assert_array_equal(ours.alpha.volume.numpy(), np.asarray(theirs.alpha.volume))
    np.testing.assert_array_equal(ours.alpha.aabb.numpy(), np.asarray(theirs.alpha.aabb))
    np.testing.assert_array_equal(ours._ray_ids, theirs._ray_ids)
    np.testing.assert_array_equal(ours.all_rays.numpy(), theirs.all_rays)
    np.testing.assert_array_equal(ours.all_rgbs.numpy(), theirs.all_rgbs)
    np.testing.assert_array_equal(ours.aabb, theirs.aabb)
    assert (ours.grid_size, ours.step_size, ours.n_samples, ours.l1_weight, ours.n_voxel_list) == (
        theirs.grid_size, theirs.step_size, theirs.n_samples, theirs.l1_weight, theirs.n_voxel_list)
    assert ours._auto_cap == theirs._auto_cap
    assert ours._effective_sample_cap() == theirs._effective_sample_cap()
    assert ours._sampler_birth == theirs._sampler_birth
    # The next ids, then both samplers put back.
    np.testing.assert_array_equal(ours.sampler.nextids().numpy(), theirs.sampler.nextids())
    ours.sampler._curr -= ours.sampler.batch
    theirs.sampler._curr -= theirs.sampler.batch


def _teacher_forced(ours, theirs, monkeypatch, steps: int = 4):
    gen = torch.Generator()  # the jitter comes from JAX
    losses_j, losses_t = [], []
    for _ in range(steps):
        jitter = _step_jitter(theirs)
        monkeypatch.setattr(tv, "_ray_jitter", lambda g, n, device: torch.from_numpy(jitter))
        losses_j.append(float(theirs.train_block(1)[0]))
        losses_t.append(float(ours.train_step(*ours.next_batch(), gen)))
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_resumes_across_packages(tmp_path, monkeypatch, direction):
    jargs, targs, jds, tds, params = _cross_setup()
    path = str(tmp_path / "model.npz")
    if direction == "jax_to_port":
        with jax.disable_jit():
            theirs = JTrainer(jargs, jds, init_params=jax.tree.map(jnp.asarray, params))
        for _ in range(3):
            theirs.train_block(1)
            if theirs.iteration == 2:
                with jax.disable_jit():
                    theirs._event_update_alpha_mask(first=True)
        assert 0 < theirs.all_rays.shape[0] < jds.all_rays.shape[0]
        theirs.save(path)
        ours = TriPlaneTrainer.from_checkpoint(path, targs, tds, device="cpu")
    else:
        ours = TriPlaneTrainer(targs, tds, init_params=convert.params_from_numpy(params, "cpu"),
                               device="cpu")
        gen = torch.Generator().manual_seed(0)
        for _ in range(3):
            ours.train_step(*ours.next_batch(), gen)
            if ours.iteration == 2:
                ours._event_update_alpha_mask(first=True)
        assert ours.events[0]["refiltered"]
        ours.save(path)
        with jax.disable_jit():
            theirs = JTrainer.from_checkpoint(path, jargs, jds)
    assert ours.iteration == 3 and ours._sampler_birth == 2
    _assert_same_across(ours, theirs)
    _teacher_forced(ours, theirs, monkeypatch)


# ------------------------------------------------------ SIGTERM, guards, CLI

def test_sigterm_checkpoints_and_resumes(datasets, tmp_path):
    train_ds, test_ds = datasets
    args = resume_args(n_iters=110, lr_decay_iters=110, save_every=0, update_AlphaMask_list=[64])
    trainer = TriPlaneTrainer(args, train_ds, test_ds, str(tmp_path / "pre"), device="cpu")
    before = signal.getsignal(signal.SIGTERM)
    fired = []

    def cb(iteration, mse):
        if iteration == 100:
            fired.append(iteration)
            os.kill(os.getpid(), signal.SIGTERM)

    stats = trainer.run(progress_cb=cb)
    assert fired == [100] and stats["preempted"] and stats["iterations"] == 100
    assert signal.getsignal(signal.SIGTERM) == before
    ckpt = str(tmp_path / "pre" / "model.npz")
    with np.load(ckpt) as z:
        meta = json.loads(bytes(z["meta"]).decode())
    assert meta["iteration"] == 100 and "resume" in meta
    resumed = TriPlaneTrainer.from_checkpoint(ckpt, args, train_ds, test_ds,
                                              str(tmp_path / "post"), device="cpu")
    assert resumed.iteration == 100 and resumed.alpha is not None
    out = resumed.run()
    assert not out["preempted"] and out["iterations"] == args.n_iters
    assert resumed.events == []  # the event at 64 stays done


def test_resume_rejections(datasets, tmp_path):
    train_ds, test_ds = datasets
    args = resume_args(n_iters=4, save_every=0, update_AlphaMask_list=[])
    trainer = TriPlaneTrainer(args, train_ds, test_ds, str(tmp_path / "run"), device="cpu")
    legacy = str(tmp_path / "legacy.npz")
    save_checkpoint(legacy, trainer.params, {"subsystem": "infoinv", "iteration": 0})
    with pytest.raises(ValueError, match="no training-resume state"):
        TriPlaneTrainer.from_checkpoint(legacy, args, train_ds, test_ds, device="cpu")
    trainer.run()
    ckpt = str(tmp_path / "run" / "model.npz")
    with pytest.raises(ValueError, match="subsystem"):
        TriPlaneTrainer.from_checkpoint(ckpt, dataclasses.replace(args, subsystem="triplane"),
                                        train_ds, test_ds, device="cpu")
    # A moment of the wrong shape raises; nothing starts fresh silently.
    with np.load(ckpt) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["extra/opt/0001"] = arrays["extra/opt/0001"][..., :-1]
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **arrays)
    with pytest.raises(ValueError, match="optimizer leaf of shape"):
        TriPlaneTrainer.from_checkpoint(bad, args, train_ds, test_ds, device="cpu")
    # Ray ids past the dataset's rays (another dataset than the run's) raise.
    small = make_synthetic_dataset("train", n_views=1, wh=(40, 40))
    with pytest.raises(ValueError, match="ray ids do not index"):
        TriPlaneTrainer.from_checkpoint(ckpt, args, small, test_ds, device="cpu")


def test_cli_resumes_and_writes_scalars(tmp_path):
    """``main_torch.py --ckpt`` in training mode resumes the run; the
    ``scalars.jsonl`` rows carry the JAX trainer's keys at its steps
    (`ngf_tpu/train/loop.py:1571-1626`)."""
    import main_torch

    base = ["--config", os.path.join(REPO, "configs", "synthetic_infoinv_tpu.txt"),
            "--device", "cpu", "--plane_res", "32", "--alpha_grid_res", "16",
            "--datadir", "synthetic:views=2,wh=16,test_views=1", "--nSamples", "48",
            "--batch_size", "256", "--open_sample_cap", "32", "--update_AlphaMask_list", "4",
            "--density_shift", "0", "--render_test", "1", "--progress_refresh_rate", "2",
            "--vis_every", "6", "--save_every", "3", "--lr_decay_iters", "8",
            "--basedir", str(tmp_path), "--expname", "run"]
    first = main_torch.main(base + ["--n_iters", "5"])
    assert first["iterations"] == 5 and not first["preempted"]
    ckpt = str(tmp_path / "run" / "model.npz")
    out = main_torch.main(base + ["--n_iters", "8", "--ckpt", ckpt])
    assert out["iterations"] == 8 and len(out["train_mses"]) == 3 and out["events"] == []
    assert len(out["test_psnrs"]) == 1 and np.isfinite(out["test_psnrs"]).all()
    rows = [json.loads(line) for line in open(tmp_path / "run" / "scalars.jsonl")]
    train = {"train/psnr", "train/mse", "train/l1_weight", "train/shaded_groups_p999"}
    by_keys = {}
    for r in rows:
        by_keys.setdefault(frozenset(set(r) - {"step", "wall"}), []).append(r["step"])
    assert by_keys == {
        frozenset(train): [2, 4, 6, 8],
        frozenset({"ckpt/blocked_s"}): [3, 6],
        frozenset({"event/mask_grid_s", "event/mask_filter_s", "event/mask_counts_s"}): [4],
        frozenset({"test/psnr"}): [6],
    }
