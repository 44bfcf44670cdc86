"""The parallel modes of the port (`ngf_tpu_torch/parallel/`, the trainer's
``mesh``) against the JAX package's meshes, on the CPU.

The port's ranks are processes: each test starts its workers with
``subprocess`` (gloo, ``--device cpu``, a free port, one intra-op thread),
as `tests/test_distributed.py` starts JAX's, with a finite
``init_process_group`` timeout and ``communicate(timeout=...)``, so that a
hang fails one test instead of the suite's clock. The workers read the
inputs the JAX side gets (numpy arrays written by the test) and write what
they computed back; the JAX side runs in the test's process on the 8 CPU
devices of `tests/conftest.py`.

- ``maybe_initialize_distributed``: its opt-in, a two-process reduction,
  its idempotence, the meshes' rank placement and groups, ``shard_batch``,
  the collectives' gradients, and ``--mesh_shape`` against the world size.
- ``render_rays_sp`` on 4 ranks (2 x 2) against `ngf_tpu`'s on
  ``make_mesh_2d(2, 2)``, with the same converted parameters and no
  jitter: rgb, acc and depth to 1e-5, the plane gradient (summed over the
  ranks) against ``jax.grad`` of the JAX sharded loss within 1e-5 of its
  largest entry.
- The data-parallel trainer on 2 ranks against `ngf_tpu`'s trainer (one
  device: a data mesh computes the same global step), six staged grouped
  steps with the mask event after the third, the same batches and per-ray
  jitter: losses to rtol 2e-3 / atol 2e-5 (`tests/test_torch_staged_parity.py`);
  the mask, kept rays, measured capacity and ``rgb_stat`` exact, and the two
  ranks' parameters equal bit for bit.
- The sample-parallel trainer on a 2 x 2 mesh with L1 on against the JAX
  trainer on ``make_mesh_2d(2, 2)``: eight steps, losses to rtol 2e-3 (a
  regulariser counted on every sample rank moves them further: see the
  test), the four ranks' parameters bit-equal.
- ``main_torch.main(["--mesh_shape", "2x2", ...])`` on 4 ranks: one
  checkpoint, from rank 0, resumed at world 1; SIGTERM to one of two ranks:
  both stop at the same step, exit 0, one checkpoint written.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time

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
from ngf_tpu.parallel.mesh import make_mesh_2d as j_make_mesh_2d  # noqa: E402
from ngf_tpu.parallel.sample_parallel import render_rays_sp as j_render_rays_sp  # noqa: E402
from ngf_tpu.render import volume as jv  # noqa: E402
from ngf_tpu.train.loop import TriPlaneTrainer as JTrainer  # noqa: E402
from ngf_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint  # noqa: E402
from ngf_tpu_torch.parallel import mesh as pm  # noqa: E402
from ngf_tpu_torch.parallel.sample_parallel import exclusive_prefix  # noqa: E402

CONFIG = os.path.join(REPO, "configs", "synthetic_infoinv_tpu.txt")
DATADIR = "synthetic:views=2,wh=16,test_views=1"
TIMEOUT_S = 240
PLANES = ("plane_xy", "plane_yz", "plane_xz")

# One script for every worker: argv[1] the mode, argv[2] the directory it
# reads its inputs from and writes its outputs to.
WORKER = r'''
import datetime, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from ngf_tpu_torch.parallel import mesh as pm
assert pm.maybe_initialize_distributed(timeout=datetime.timedelta(seconds=120))
assert pm.maybe_initialize_distributed(), "a second call is a no-op True"
import torch.distributed as dist
from ngf_tpu_torch.convert import named_leaves

mode, io = sys.argv[1], sys.argv[2]
rank, world = dist.get_rank(), dist.get_world_size()


def save(**arrays):
    np.savez(os.path.join(io, f"rank{rank}.npz"), **arrays)


def leaves(params):
    return {f"p/{k}": v.detach().numpy() for k, v in named_leaves(params)}


if mode == "init":
    from ngf_tpu_torch.parallel import collectives
    import main_torch
    x = torch.tensor([1.0 + 10 * rank])
    dist.all_reduce(x)
    out = {"rank": rank, "world": world, "sum": float(x)}
    m1 = pm.make_mesh()
    m2 = pm.make_mesh_2d(1, 2)
    m3 = pm.make_mesh_2d(2, 1)
    out["mesh1"] = [m1.shape, list(m1.axis_names), m1.data_index, m1.sample_index]
    out["mesh_1x2"] = [m2.shape, list(m2.axis_names), m2.data_index, m2.sample_index]
    out["mesh_2x1"] = [m3.shape, m3.data_index, m3.sample_index]
    out["shard"] = pm.shard_batch(m1, torch.arange(8)).tolist()
    # psum_replicated: the sum forward, the identity backward.
    a = torch.tensor([2.0 + rank], requires_grad=True)
    s = collectives.psum_replicated(a * 3.0, m2.sample_group)
    s.sum().backward()
    out["psum"], out["psum_grad"] = float(s), float(a.grad)
    # all_gather_totals: the stack forward; backward this row's summed cotangents.
    b = torch.tensor([1.0 + rank, 5.0], requires_grad=True)
    st = collectives.all_gather_totals(b, m2.sample_group)
    (st * torch.tensor([[1.0, 2.0], [3.0, 4.0]]) * (1 + rank)).sum().backward()
    out["stack"], out["stack_grad"] = st.tolist(), b.grad.tolist()
    out["any"] = [collectives.any_rank(rank == 1), collectives.any_rank(False)]
    for shape in ("2x2", "4x1"):
        try:
            main_torch.make_training_mesh(shape)
            out[shape] = "built"
        except ValueError as e:
            out[shape] = str(e)
    out["no_flag"] = main_torch.make_training_mesh("").shape
    print("RESULT " + json.dumps(out), flush=True)
elif mode == "render":
    from ngf_tpu_torch.fields.triplane import TriPlaneConfig
    from ngf_tpu_torch.parallel.sample_parallel import render_rays_sp
    from ngf_tpu_torch.render.volume import RenderConfig
    from ngf_tpu_torch.utils.checkpoint import load_checkpoint
    spec = json.load(open(os.path.join(io, "spec.json")))
    params, _, _, _ = load_checkpoint(os.path.join(io, "params.npz"), "cpu")
    params["plane_xy"].requires_grad_(True)
    data = np.load(os.path.join(io, "inputs.npz"))
    mesh = pm.make_mesh_2d(2, 2)
    rays, g_rgb, g_acc = (pm.shard_batch(mesh, torch.from_numpy(data[k]))
                          for k in ("rays", "g_rgb", "g_acc"))
    rcfg = RenderConfig(**{k: tuple(map(tuple, v)) if k == "aabb" else v
                           for k, v in spec["rcfg"].items()})
    out = render_rays_sp(params, TriPlaneConfig(**spec["cfg"]), rcfg, rays, mesh)
    ((out["rgb_map"] * g_rgb).sum() + (out["acc_map"] * g_acc).sum()).backward()
    save(rgb=out["rgb_map"].detach().numpy(), acc=out["acc_map"].detach().numpy(),
         depth=out["depth_map"].numpy(), g_xy=params["plane_xy"].grad.numpy())
    print("RESULT " + json.dumps({"rank": rank}), flush=True)
elif mode in ("data", "sample"):
    from ngf_tpu_torch.config import config_parser
    from ngf_tpu_torch.data import load_dataset
    from ngf_tpu_torch.render import volume as tv
    from ngf_tpu_torch.train.loop import TriPlaneTrainer
    from ngf_tpu_torch.utils.checkpoint import load_checkpoint
    spec = json.load(open(os.path.join(io, "spec.json")))
    args = config_parser(spec["argv"])
    params, _, _, _ = load_checkpoint(os.path.join(io, "params.npz"), "cpu")
    jitter = np.load(os.path.join(io, "jitter.npy"))
    step = [0]
    tv._ray_jitter = lambda g, n, device: torch.from_numpy(jitter[step[0]])
    mesh = pm.make_mesh() if mode == "data" else pm.make_mesh_2d(2, 2)
    ds = load_dataset("synthetic", spec["datadir"], split="train", is_stack=False)
    trainer = TriPlaneTrainer(args, ds, init_params=params, device="cpu", mesh=mesh)
    gen = torch.Generator()
    losses, rec, first = [], {}, {}
    apply = trainer.optimizer.step

    def step_and_keep_first():
        # The first step's reduced gradients, as the optimizer takes them.
        if not first:
            first.update({f"g/{k}": p.grad.numpy().copy()
                          for k, p in named_leaves(trainer.params) if p.grad is not None})
        apply()

    trainer.optimizer.step = step_and_keep_first
    for _ in range(spec["steps"]):
        rays, rgbs = trainer.next_batch()
        losses.append(float(trainer.train_step(rays, rgbs, gen)))
        step[0] += 1
        if trainer.iteration in spec["events"]:
            rec = trainer._event_update_alpha_mask(first=trainer.alpha is None)
    extra = {}
    if trainer.alpha is not None:
        extra = dict(volume=trainer.alpha.volume.numpy(), aabb=trainer.alpha.aabb.numpy(),
                     ray_ids=trainer._ray_ids, auto_cap=np.int64(trainer._auto_cap),
                     cap=np.int64(trainer._effective_sample_cap()))
    save(losses=np.array(losses), rgb_stat=np.int64(trainer.rgb_stat), **extra, **first,
         **leaves(trainer.params))
    print("RESULT " + json.dumps({"rank": rank, "event": rec}, default=str), flush=True)
elif mode == "main":
    import main_torch
    stats = main_torch.main(json.load(open(os.path.join(io, "argv.json"))))
    print("RESULT " + json.dumps({"rank": rank, "iterations": stats["iterations"],
                                  "preempted": stats["preempted"],
                                  "test_psnrs": stats["test_psnrs"]}), flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _start(io, mode: str, n: int) -> list:
    """``n`` worker processes of ``mode`` over gloo on a free port."""
    script = os.path.join(str(io), "worker.py")
    with open(script, "w") as f:
        f.write(WORKER)
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   NGF_COORDINATOR=f"localhost:{port}", NGF_NUM_PROCESSES=str(n),
                   NGF_PROCESS_ID=str(rank))
        env.pop("NGF_DISTRIBUTED", None)
        procs.append(subprocess.Popen([sys.executable, script, mode, str(io)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs) -> list[dict]:
    """Every worker's output; a worker that failed or hung fails the test."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out[-4000:]}"
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, out[-4000:]
        results.append(json.loads(lines[-1][len("RESULT "):]))
    return results


def _run(io, mode: str, n: int) -> list[dict]:
    return _finish(_start(io, mode, n))


def _rank_npz(io, rank: int) -> dict:
    with np.load(os.path.join(str(io), f"rank{rank}.npz")) as z:
        return dict(z)


# ------------------------------------------------------------------- set-up


def test_noop_without_optin(monkeypatch):
    for var in ("NGF_COORDINATOR", "NGF_NUM_PROCESSES", "NGF_PROCESS_ID", "NGF_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(pm, "_INITIALIZED", False)
    assert pm.maybe_initialize_distributed() is False
    monkeypatch.setenv("NGF_DISTRIBUTED", "0")
    assert pm.maybe_initialize_distributed() is False
    with pytest.raises(RuntimeError, match="process group"):
        pm.make_mesh()


@pytest.fixture(scope="module")
def init_results(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("init"), "init", 2)


def test_two_process_reduction_and_meshes(init_results):
    """The reduction crossed the processes; the 1-D mesh and the 1 x 2 and
    2 x 1 meshes place rank r at (r // S, r % S); ``shard_batch`` keeps
    rows [i b, (i + 1) b)."""
    for rank, r in enumerate(init_results):
        assert (r["rank"], r["world"], r["sum"]) == (rank, 2, 1.0 + 11.0)
        assert r["mesh1"] == [{"data": 2}, ["data"], rank, 0]
        assert r["mesh_1x2"] == [{"data": 1, "sample": 2}, ["data", "sample"], 0, rank]
        assert r["mesh_2x1"] == [{"data": 2, "sample": 1}, rank, 0]
        assert r["shard"] == list(range(4 * rank, 4 * rank + 4))
        assert r["any"] == [True, False]


def test_collectives_gradients(init_results):
    """``psum_replicated`` sums forward and passes the cotangent through
    (3, not 6: the loss is held whole on both ranks); ``all_gather_totals``
    stacks forward and gives each rank the sum of both ranks' cotangents of
    its row."""
    for rank, r in enumerate(init_results):
        assert r["psum"] == 3.0 * (2.0 + 3.0) and r["psum_grad"] == 3.0
        assert r["stack"] == [[1.0, 5.0], [2.0, 5.0]]
        # Row r's cotangent on rank q is (1 + q) * [[1, 2], [3, 4]][r].
        assert r["stack_grad"] == [3.0 * c for c in ([1.0, 2.0], [3.0, 4.0])[rank]]


def test_mesh_shape_must_match_the_world(init_results):
    for r in init_results:
        assert r["2x2"] == "--mesh_shape 2x2 needs 4 ranks; this run has 2"
        assert r["4x1"] == "--mesh_shape 4x1 needs 4 ranks; this run has 2"
        assert r["no_flag"] == {"data": 2}


def test_exclusive_prefix_gradient_without_division():
    """The masked product of the earlier shards' totals: its value, and a
    gradient into every row (zero for the later ones) that stays finite
    where a total is 0."""
    totals = torch.tensor([[0.5, 0.0], [0.25, 0.3], [2.0, 0.7]], requires_grad=True)
    t0 = exclusive_prefix(totals, 2)
    assert t0.tolist() == [0.125, 0.0]
    t0.sum().backward()
    assert torch.equal(totals.grad, torch.tensor([[0.25, 0.3], [0.5, 0.0], [0.0, 0.0]]))


# ---------------------------------------------------------- render_rays_sp


@pytest.fixture(scope="module")
def render_case(tmp_path_factory):
    """4 ranks of ``render_rays_sp`` on a 2 x 2 mesh and the JAX renderer
    on ``make_mesh_2d(2, 2)``, from the same parameters (density bias 6:
    acc about 0.7, the later shard starting at t0 about 0.5), 32 rays, 64
    samples, no jitter."""
    io = tmp_path_factory.mktemp("render")
    cfg = dataclasses.replace(jt.TriPlaneConfig.infoinv_preset(), plane_res=16)
    params = jax.device_get(jt.init_triplane(jax.random.PRNGKey(5), cfg))
    params["density_decoder"]["mlp"]["layers"][-1]["b"] = np.full((1,), 6.0, np.float32)
    # Marching starts at ``near``, past every ray's entry into the box: no
    # first sample on a face, where the jitted JAX renderer's fused
    # ``o + d * t`` would move it in or out.
    rcfg = jv.RenderConfig(aabb=((-1.5,) * 3, (1.5,) * 3), near=2.7, n_samples=64,
                           step_size=0.05, white_bg=True)
    rng = np.random.default_rng(0)
    n = 32
    origins = rng.normal(size=(n, 3)).astype(np.float32)
    origins = 4.0 * origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    dirs = -origins + rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays = np.concatenate([origins, dirs], -1).astype(np.float32)
    entry = np.max(np.minimum((1.5 - origins) / dirs, (-1.5 - origins) / dirs), -1)
    assert entry.max() < 2.6
    g_rgb = rng.normal(size=(n, 3)).astype(np.float32)
    g_acc = rng.normal(size=n).astype(np.float32)
    j_save_checkpoint(os.path.join(str(io), "params.npz"), params, meta={})
    np.savez(os.path.join(str(io), "inputs.npz"), rays=rays, g_rgb=g_rgb, g_acc=g_acc)
    spec = {"cfg": dataclasses.asdict(cfg),
            "rcfg": {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)
                     if f.name in ("aabb", "near", "far", "n_samples", "step_size",
                                   "distance_scale", "ray_march_weight_thres", "white_bg")}}
    with open(os.path.join(str(io), "spec.json"), "w") as f:
        json.dump(spec, f)
    procs = _start(io, "render", 4)

    mesh = j_make_mesh_2d(2, 2)
    jparams = jax.tree.map(jnp.asarray, params)

    def loss(p):
        out = j_render_rays_sp(p, cfg, rcfg, jnp.asarray(rays), None, mesh)
        return (out["rgb_map"] * g_rgb).sum() + (out["acc_map"] * g_acc).sum(), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams)
    _finish(procs)
    got = [_rank_npz(io, r) for r in range(4)]
    return got, jax.device_get(want), np.asarray(grads["plane_xy"])


def test_render_rays_sp_matches_jax(render_case):
    """rgb, acc and depth of each data rank's rays to 1e-5; the two sample
    ranks of a data rank agree bit for bit."""
    got, want, _ = render_case
    for d in range(2):
        a, b = got[2 * d], got[2 * d + 1]
        for k in ("rgb", "acc", "depth"):
            assert np.array_equal(a[k], b[k]), k
        rows = slice(16 * d, 16 * (d + 1))
        for k, j in (("rgb", "rgb_map"), ("acc", "acc_map"), ("depth", "depth_map")):
            np.testing.assert_allclose(a[k], want[j][rows], rtol=0, atol=1e-5, err_msg=k)
    acc = want["acc_map"]
    assert 0.5 < acc.min() and acc.max() < 0.9


def test_render_rays_sp_plane_gradient_matches_jax_grad(render_case):
    """The plane_xy gradient summed over the four ranks (each holds its
    rays' share through its samples) against ``jax.grad`` of the JAX
    sharded loss, within 1e-5 of its largest entry."""
    got, _, want = render_case
    total = sum(g["g_xy"] for g in got)
    scale = float(np.abs(want).max())
    assert scale > 1e-3
    np.testing.assert_allclose(total, want, rtol=0, atol=1e-5 * scale)
    # Each sample shard carries a share of its own.
    assert all(np.abs(g["g_xy"]).max() > 1e-3 * scale for g in got)


# ----------------------------------------------------------------- trainers


def _step_jitters(jtrainer, steps: int, n: int) -> np.ndarray:
    """The (n, 1) jitter each of the JAX trainer's next one-step blocks
    draws (`train_block`: split the key, one key a step; the renderer:
    split into the jitter's and the background's)."""
    key, out = jtrainer.key, []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        k_jit, _ = jax.random.split(jax.random.split(sub, 1)[0])
        out.append(np.array(jax.random.uniform(k_jit, (n, 1), dtype=jnp.float32)))
    return np.stack(out)


def _sp_first_grads(theirs, mesh) -> dict:
    """``jax.grad`` of the JAX sample-parallel trainer's loss
    (`ngf_tpu/train/loop.py:411-482`: MSE + L1 through ``render_rays_sp``)
    at its first step: its first batch, key and weights, flattened by path."""
    import copy

    from ngf_tpu_torch.convert import named_leaves

    ids = copy.deepcopy(theirs.sampler).nextids()
    rays, rgbs = jnp.asarray(theirs.all_rays[ids]), jnp.asarray(theirs.all_rgbs[ids])
    key = jax.random.split(jax.random.split(theirs.key)[1], 1)[0]
    n_sp = mesh.shape["sample"]
    rcfg = dataclasses.replace(theirs._render_cfg(), sample_cap=0, rgb_cap=0, group_size=0,
                               mask_stride=1, n_samples=-(-theirs.n_samples // n_sp) * n_sp)
    l1_w = theirs.l1_weight

    def loss(p):
        out = j_render_rays_sp(p, theirs.model_cfg, rcfg, rays, key, mesh, is_train=True)
        return jnp.mean((out["rgb_map"] - rgbs) ** 2) + l1_w * jt.density_l1(p)

    grads = jax.device_get(jax.jit(jax.grad(loss))(theirs.params))
    return {f"g/{k}": np.asarray(v) for k, v in named_leaves(grads)}


def _trainer_case(io, mode, n_ranks, argv, steps, events, jitter_rows, mesh=None, prepare=None):
    """The JAX trainer (``mesh`` or one device) from JAX initial weights,
    and ``n_ranks`` port workers of ``mode`` from the same weights, on the
    same batches and per-ray jitter. Returns (JAX losses, JAX trainer,
    each rank's outputs, the port's event record, and on a 2-D mesh the JAX
    first step's gradients)."""
    jargs = j_config_parser(argv)
    jds = j_registry.load_dataset("synthetic", DATADIR, split="train", is_stack=False)
    cfg = jt.TriPlaneConfig(**dataclasses.asdict(jt.TriPlaneConfig.infoinv_preset(
        infoinv=jargs.infoinv)))
    cfg = dataclasses.replace(cfg, density_shift=jargs.density_shift,
                              distance_scale=jargs.distance_scale, plane_res=jargs.plane_res,
                              gauge_res=jargs.gauge_res)
    params = jax.device_get(jt.init_triplane(jax.random.PRNGKey(3), cfg))
    if prepare is not None:
        prepare(params)
    with jax.disable_jit():
        theirs = JTrainer(jargs, jds, init_params=jax.tree.map(jnp.asarray, params), mesh=mesh)
    jitter = _step_jitters(theirs, steps, jitter_rows)
    if jitter_rows != jargs.batch_size:  # each data shard draws its rows' worth: tile
        jitter = np.tile(jitter, (1, jargs.batch_size // jitter_rows, 1))
    j_save_checkpoint(os.path.join(str(io), "params.npz"), params, meta={})
    np.save(os.path.join(str(io), "jitter.npy"), jitter)
    with open(os.path.join(str(io), "spec.json"), "w") as f:
        json.dump({"argv": argv + ["--device", "cpu"], "datadir": DATADIR, "steps": steps,
                   "events": list(events)}, f)
    procs = _start(io, mode, n_ranks)
    first = _sp_first_grads(theirs, mesh) if mesh is not None else None
    losses = []
    for _ in range(steps):
        losses.append(float(theirs.train_block(1)[0]))
        if theirs.iteration in events:
            with jax.disable_jit():
                theirs._event_update_alpha_mask(first=theirs.alpha is None)
    results = _finish(procs)
    return (np.array(losses), theirs, [_rank_npz(io, r) for r in range(n_ranks)],
            results[0]["event"], first)


STAGED_ARGV = [
    "--config", CONFIG, "--datadir", DATADIR, "--plane_res", "32", "--nSamples", "96",
    "--batch_size", "64", "--open_sample_cap", "32", "--alpha_grid_res", "12",
    "--n_iters", "6", "--prewarm_events", "0", "--update_AlphaMask_list", "3",
]


def _staged_weights(params):
    # As `tests/test_torch_staged_parity.py`: the event finds part of the
    # lattice occupied and drops some of the rays.
    for name in PLANES:
        params[name] = params[name] * np.float32(300.0)
    params["density_decoder"]["mlp"]["layers"][-1]["b"] = np.full((1,), 0.0, np.float32)


@pytest.fixture(scope="module")
def data_case(tmp_path_factory):
    return _trainer_case(tmp_path_factory.mktemp("data"), "data", 2, STAGED_ARGV, 6, (3,), 64,
                         prepare=_staged_weights)


def test_data_parallel_trainer_losses_match_jax(data_case):
    losses_j, _, ranks, _, _ = data_case
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses_j, rtol=2e-3, atol=2e-5)
    assert np.abs(np.diff(losses_j)).max() > 1e-4


def test_data_parallel_events_and_replicas_exact(data_case):
    """The mask, its box, the kept rays, the measured capacity and the
    global ``rgb_stat`` of the JAX trainer, exactly, on both ranks; the
    ranks' parameters equal bit for bit."""
    _, theirs, ranks, rec, _ = data_case
    assert rec["first"] and 0 < rec["rays_kept"] < rec["rays_before"]
    for r in ranks:
        np.testing.assert_array_equal(r["volume"], np.asarray(theirs.alpha.volume))
        np.testing.assert_array_equal(r["aabb"], np.asarray(theirs.alpha.aabb))
        np.testing.assert_array_equal(r["ray_ids"], theirs._ray_ids)
        assert int(r["auto_cap"]) == theirs._auto_cap
        assert int(r["cap"]) == theirs._effective_sample_cap()
        assert int(r["rgb_stat"]) == theirs._rgb_stat > 0
    keys = [k for k in ranks[0] if k.startswith("p/")]
    assert len(keys) >= 10
    for k in keys:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k


SP_ARGV = [
    "--config", CONFIG, "--datadir", DATADIR, "--plane_res", "32", "--nSamples", "64",
    "--batch_size", "64", "--group_size", "0", "--sample_cap", "0", "--n_iters", "8",
    "--prewarm_events", "0", "--mesh_shape", "2x2", "--L1_weight_initial", "0.02",
]


@pytest.fixture(scope="module")
def sample_case(tmp_path_factory):
    # JAX's shards draw their rows' jitter from one key: the same 32 numbers
    # for both data shards.
    return _trainer_case(tmp_path_factory.mktemp("sample"), "sample", 4, SP_ARGV, 8, (), 32,
                         mesh=j_make_mesh_2d(2, 2))


def test_sample_parallel_trainer_matches_jax(sample_case):
    """Eight steps on a 2 x 2 mesh with L1 at 0.02 against the JAX trainer
    on ``make_mesh_2d(2, 2)``: losses to rtol 2e-3."""
    losses_j, theirs, ranks, _, _ = sample_case
    assert theirs._sample_parallel
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses_j, rtol=2e-3, atol=2e-5)


def test_sample_parallel_first_step_gradients_match_jax_grad(sample_case):
    """The first step's gradients as every rank hands them to the
    optimizer (the world's sum over the data ranks' mean) against
    ``jax.grad`` of the JAX trainer's loss, each leaf within 1e-4 of its
    largest entry. L1 counted on both sample ranks would add its gradient
    twice: about half of each plane's largest entry here. (The losses alone
    do not show it in eight steps: Adam moves a texel whose gradient is L1's
    sign alone by lr whatever its weight.)"""
    _, _, ranks, _, want = sample_case
    assert len(want) >= 10
    for r in ranks:
        for k, w in want.items():
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(r[k], w, rtol=0, atol=1e-4 * max(scale, 1e-12), err_msg=k)


def test_sample_parallel_replicas_bit_equal(sample_case):
    _, _, ranks, _, _ = sample_case
    keys = [k for k in ranks[0] if k.startswith("p/")]
    for r in ranks[1:]:
        for k in keys:
            assert np.array_equal(ranks[0][k], r[k]), k


# ---------------------------------------------------------------------- CLI

CLI_ARGV = [
    "--config", CONFIG, "--datadir", DATADIR, "--device", "cpu", "--plane_res", "32",
    "--nSamples", "64", "--batch_size", "64", "--open_sample_cap", "32",
    "--alpha_grid_res", "12", "--render_test", "0", "--N_vis", "0",
    "--progress_refresh_rate", "2",
]


def test_main_cli_mesh_shape_2x2_resumes_at_world_1(tmp_path):
    """``--mesh_shape 2x2`` through ``main_torch.main`` on 4 ranks, across
    a mask event: one ``model.npz`` (rank 0's) at the last step; resumed by
    one process (no mesh) to two more steps."""
    import main_torch

    argv = CLI_ARGV + ["--basedir", str(tmp_path / "runs"), "--expname", "sp", "--n_iters", "4",
                       "--update_AlphaMask_list", "2", "--mesh_shape", "2x2"]
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(argv, f)
    results = _run(tmp_path, "main", 4)
    assert [r["iterations"] for r in results] == [4] * 4
    assert not any(r["preempted"] for r in results)
    run = tmp_path / "runs" / "sp"
    assert sorted(p.name for p in run.glob("*.npz")) == ["model.npz"]
    from ngf_tpu_torch.utils.checkpoint import load_checkpoint

    _, meta, vol, _ = load_checkpoint(str(run / "model.npz"), "cpu")
    assert meta["iteration"] == 4 and vol is not None
    assert (run / "log.txt").read_text().count("Iteration") == 2
    stats = main_torch.main(CLI_ARGV + [
        "--basedir", str(tmp_path / "runs"), "--expname", "resumed", "--n_iters", "6",
        "--update_AlphaMask_list", "2", "--ckpt", str(run / "model.npz")])
    assert stats["iterations"] == 6 and len(stats["train_mses"]) == 2
    assert all(np.isfinite(stats["train_mses"]))


def test_sigterm_on_one_rank_stops_every_rank(tmp_path):
    """SIGTERM to rank 1 of a two-rank data mesh: both ranks stop at the
    same step (the next log step, where they agree), exit 0 and report
    preemption; rank 0 writes the one checkpoint, at that step."""
    argv = CLI_ARGV + ["--basedir", str(tmp_path / "runs"), "--expname", "term",
                       "--n_iters", "2000", "--update_AlphaMask_list", "5000"]
    with open(tmp_path / "argv.json", "w") as f:
        json.dump(argv, f)
    procs = _start(tmp_path, "main", 2)
    log = tmp_path / "runs" / "term" / "log.txt"
    t0 = time.time()
    while not (log.exists() and log.read_text().count("Iteration") >= 3):
        assert time.time() - t0 < TIMEOUT_S and all(p.poll() is None for p in procs), \
            [p.communicate()[0][-3000:] for p in procs if p.poll() is not None]
        time.sleep(0.05)
    procs[1].send_signal(signal.SIGTERM)
    results = _finish(procs)
    its = [r["iterations"] for r in results]
    assert its[0] == its[1] < 2000 and its[0] % 2 == 0
    assert all(r["preempted"] and r["test_psnrs"] == [] for r in results)
    run = tmp_path / "runs" / "term"
    assert sorted(p.name for p in run.glob("*.npz")) == ["model.npz"]
    from ngf_tpu_torch.utils.checkpoint import load_checkpoint

    assert load_checkpoint(str(run / "model.npz"), "cpu")[1]["iteration"] == its[0]
