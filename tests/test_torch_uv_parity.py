"""The port's UV trainer (`ngf_tpu_torch/train/uv_loop.py:UVTrainer`)
against the JAX trainer (`ngf_tpu/train/uv_loop.py:UVTrainer`, compiled as
it runs) on the CPU, on the same batches with JAX's own draws injected:

- six steps of the square and sphere primitives, the 'lambda' and
  'plateau' policies (blocks of 2: the plateau controller reads a block's
  mean colour loss), a frozen subnetwork, bfloat16: every loss at every
  step to rtol 2e-3 (float32) or 2e-2 (bfloat16), as
  `tests/test_training_parity.py` holds the JAX trainer to its torch
  oracle. Each block starts from the JAX trainer's state, carried into the
  port through its checkpoint (parameters, moments, counts, plateau):
  free-running, six steps of this tiny model diverge in float32 by 1.5%
  (square) and 8% (sphere) between the JAX trainer's own compiled and eager
  runs, because Adam's first steps move every weight by about lr whatever
  the size of its gradient, so a gradient at the level of float32 rounding
  moves it either way;
- the gradient of every trainable leaf at each case's first step, the
  port trainer's ``.grad`` against ``jax.grad`` of the JAX trainer's loss
  on the same weights and draws (see `_assert_first_step_gradients`);
- checkpoints both ways: a port ``{epoch}_net_NeuTex.npz`` loads in the JAX
  trainer and a JAX one in the port, with the parameters, every Adam moment,
  both counts, the step and the plateau state equal, and the next step
  equal;
- the CLIs tiny on the CPU (train, SIGTERM in a subprocess, resume,
  ``uv_test_torch.py`` with an edited texture) and ``chip_smoke.uv_phase``.
"""

import dataclasses
import json
import os
import signal
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

from ngf_tpu.data.dtu import SyntheticDtuDataset  # noqa: E402
from ngf_tpu.fields import neutex as jn  # noqa: E402
from ngf_tpu.train.uv_loop import UVTrainer as JTrainer  # noqa: E402
from ngf_tpu_torch.convert import adam_to_optax_leaves, named_leaves  # noqa: E402
from ngf_tpu_torch.fields import neutex as tn  # noqa: E402
from ngf_tpu_torch.train.uv_loop import UVTrainer  # noqa: E402

RAYS_SIDE = 4
LR = 1e-4  # the UV recipe's (`UV-Mapping/dtu_train.sh`)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(primitive="square", dtype="float32"):
    return jn.NeuTexConfig(primitive_type=primitive, sample_num=8, points_per_primitive=64,
                           geo_hidden=32, geo_layers=2, tex_width=32, tex_layers1=2,
                           tex_layers2=1, gauge_hidden=32, inverse_hidden=32,
                           compute_dtype=dtype)


def _dataset(seed=0):
    return SyntheticDtuDataset(n_views=4, wh=(16, 16), random_sample="balanced",
                               random_sample_size=RAYS_SIDE, seed=seed)


def _pair(jcfg, tmp_path=None, **kw):
    """A JAX trainer and a port trainer on the CPU with the JAX weights."""
    ds = _dataset()
    save = None if tmp_path is None else str(tmp_path / "jax")
    jt = JTrainer(jcfg, ds, lr=LR, niter=4, niter_decay=3, seed=1, save_dir=save, **kw)
    tt = UVTrainer(tn.NeuTexConfig(**dataclasses.asdict(jcfg)), ds, lr=LR, niter=4,
                   niter_decay=3, seed=1, device="cpu",
                   save_dir=None if tmp_path is None else str(tmp_path / "port"), **kw)
    tt.load_params(jax.device_get(jt.params))
    return ds, jt, tt


def _jax_draws(jt, steps):
    """The draws of the JAX trainer's next block of ``steps``
    (`train_block`: split the key, one key a step; `neutex_forward`: split
    it into the jitter's and the template's)."""
    _, sub = jax.random.split(jt.key)
    out = []
    for k in jax.random.split(sub, steps):
        k_ray, k_tmpl = jax.random.split(k)
        out.append({
            "u": np.array(jax.random.uniform(k_ray, (1, RAYS_SIDE ** 2, jt.cfg.sample_num),
                                               dtype=jnp.float32)),
            "template": np.array(jn.template_random_points(k_tmpl, jt.cfg,
                                                             jt.cfg.points_per_primitive)),
        })
    return out


def _block(jt, tt, items):
    draws = _jax_draws(jt, len(items))
    want = jt.train_block(items)
    got = tt.train_block(items, draws=draws)
    return want, got


def _rel_l1(a, b):
    d, n = np.abs(a - b).sum(), np.abs(b).sum()
    return d / n if n else (np.inf if d else 0.0)


def _jax_gradient(jt, cfg, item, steps):
    """``jax.grad`` of the JAX trainer's loss (`uv_loop.py` ``loss_fn``) at
    its weights, on the first step's key of its next block of ``steps``."""
    _, sub = jax.random.split(jt.key)
    key = jax.random.split(sub, steps)[0]
    weights = dict(jt.loss_weights)

    def loss(p):
        out = jn.neutex_forward(p, cfg, key, item["campos"], item["raydir"],
                                item["background_color"])
        return jn.neutex_losses(out, item["gt_image"], item.get("transmittance"), weights)[0]

    return dict(named_leaves(jax.device_get(jax.jit(jax.grad(loss))(jt.params))))


def _port_gradient_float64(params, cfg, item, draw, weights):
    """The port's gradient of the float32 recipe run in float64 on the
    weights ``params``, as a witness of float32's rounding."""
    cfg = tn.NeuTexConfig(**{**dataclasses.asdict(cfg), "compute_dtype": "float32"})
    p = jax.tree.map(lambda a: torch.tensor(np.asarray(a), dtype=torch.float64,
                                            requires_grad=True), params)
    f64 = lambda a: torch.as_tensor(np.asarray(a)).double()  # noqa: E731
    out = tn.neutex_forward(p, cfg, f64(item["campos"]), f64(item["raydir"]),
                            f64(item["background_color"]), u=f64(draw["u"]),
                            template=f64(draw["template"]),
                            inverse=weights.get("inverse_mapping", 0) > 0)
    tn.neutex_losses(out, f64(item["gt_image"]), f64(item["transmittance"]),
                     weights)[0].backward()
    return {n: t.grad.numpy() for n, t in named_leaves(p)}


def _first_step_references(jt, jcfg, items):
    """Before a case's first block: JAX's gradient of its first step, and
    the reference that `_assert_first_step_gradients` measures rounding
    against (JAX's float32 gradient for bfloat16, else the port's float64
    one)."""
    item, steps = items[0], len(items)
    want = _jax_gradient(jt, jt.cfg, item, steps)
    if jcfg.compute_dtype == "bfloat16":
        ref = _jax_gradient(jt, dataclasses.replace(jt.cfg, compute_dtype="float32"), item, steps)
    else:
        ref = _port_gradient_float64(jax.device_get(jt.params), jcfg, item,
                                     _jax_draws(jt, steps)[0], dict(jt.loss_weights))
    return want, ref


def _assert_first_step_gradients(want, ref, got_all, bf16, frozen=()):
    """Every trainable leaf's gradient at the first step, where both
    trainers hold the same weights, against the JAX trainer's (``want``),
    in relative L1. The UV field's gradients are far from float32-exact:
    PE(10) of the sample positions feeds the gauge, PE(10) of its output
    the texture, and the tone map's slope grows as (c + 1e-5)^-0.55 on dark
    pixels, so the sphere's gauge gradient differs by 3% between JAX's
    compiled and eager runs, and by 14% from float64. The limits therefore
    take each leaf's rounding error from a reference (``ref``) that rounds
    less:

    - float32: port against JAX within 2% plus three times the port's own
      distance from its float64 run;
    - bfloat16: the port's distance from JAX's float32 gradient of the same
      weights within 2% plus three times JAX's bfloat16 distance from it.

    A zeroed gradient is 1 away in this measure and a flipped one 2, far
    outside either limit on every leaf whose rounding error is small.
    Leaves that get no gradient (the inverse network without its losses)
    must get exactly zero, and a frozen subnetwork none at all."""
    checked = 0
    for name, got in got_all.items():
        if name.startswith(frozen):
            assert got is None, name
            continue
        if not np.abs(want[name]).any():
            np.testing.assert_array_equal(got, 0.0, err_msg=name)
            continue
        if bf16:
            err, limit = _rel_l1(got, ref[name]), 0.02 + 3 * _rel_l1(want[name], ref[name])
        else:
            err, limit = _rel_l1(got, want[name]), 0.02 + 3 * _rel_l1(got, ref[name])
        assert err <= limit, (name, err, limit)
        checked += 1
    assert checked >= len(got_all) // 2


def _assert_losses(want, got, rtol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("case", ["square_lambda", "sphere_lambda", "square_plateau",
                                  "sphere_frozen_texture", "square_bf16"])
def test_six_steps_match_jax_trainer(tmp_path, case):
    primitive = "sphere" if "sphere" in case else "square"
    jcfg = _cfg(primitive, "bfloat16" if "bf16" in case else "float32")
    kw = {}
    if "plateau" in case:
        kw["lr_policy"] = "plateau"
    if "frozen" in case:
        # and the inverse-mapping loss, which alone runs the inverse network
        # on the samples' UV
        kw["freeze"] = ["texture"]
        kw["loss_weights"] = {"color": 1.0, "bg": 1.0, "origin": 1.0, "inverse_mapping": 0.5}
    ds, jt, tt = _pair(jcfg, tmp_path, **kw)
    rtol = 2e-2 if "bf16" in case else 2e-3
    block = 2 if "plateau" in case else 1
    tex0 = jax.device_get(jt.params["net_texture"])
    first = {}
    apply_update = tt._apply_update

    def keep_first_gradients():
        if not first:
            first.update({n: None if t.grad is None else t.grad.float().numpy().copy()
                          for n, t in named_leaves(tt.params)})
        apply_update()

    tt._apply_update = keep_first_gradients
    for b in range(6 // block):
        if b:
            jt.save_networks("sync", {"total_steps": jt.step_count})
            tt.load_networks("sync", jt.save_dir)
        items = [ds.sample() for _ in range(block)]
        if not b:
            refs = _first_step_references(jt, jcfg, items)
        want, got = _block(jt, tt, items)
        _assert_losses(want, got, rtol)
        if not b:
            _assert_first_step_gradients(*refs, first, "bf16" in case,
                                         ("net_texture/",) if "frozen" in case else ())
        if "plateau" in case:
            assert tt._plateau == pytest.approx(jt._plateau, rel=rtol)
    assert tt.step_count == jt.step_count == 6
    assert tt.schedule_count == 6
    if "frozen" in case:
        for name, v in named_leaves(tt.params["net_texture"]):
            np.testing.assert_array_equal(v.detach().numpy(), dict(named_leaves(tex0))[name])
        assert not any(t.requires_grad for _, t in named_leaves(tt.params["net_texture"]))
        assert len(tt.trainable) == sum(1 for k, _ in named_leaves(tt.params)
                                        if not k.startswith("net_texture"))
    if "plateau" in case:
        assert tt._plateau["best"] < float("inf")
    if "frozen" in case:
        assert want["inverse_mapping"].min() > 0


@pytest.mark.parametrize("policy", ["lambda", "step", "plateau"])
def test_optimizer_matches_optax_on_the_same_gradients(policy):
    """The port's Adam with its schedule against the JAX trainer's optax
    chain (`scale_by_adam(0.9, 0.999, 1e-8)`, `scale_by_schedule`,
    `set_to_zero` for a frozen subnetwork, the plateau multiplier) on the
    same random gradients (elements of 1e-9, 1e-3 and 1, eps 1e-8 between),
    seven updates across the lambda decay, a step of the 'step' policy and a
    plateau cut: every weight's total move to 2e-4 of it plus 2e-5 of lr a
    step and two float32 roundings of the weight it lands on (optax takes
    the bias corrections 1 - b^t in float32, where 1 - 0.999 keeps four
    digits, torch in double), the moments to 1e-4 plus 1e-6 of the leaf's
    largest (``lerp`` against optax's sum), the counts exactly."""
    jcfg = _cfg("square")
    kw = {"lr_policy": policy, "freeze": ["inverse"], "lr_decay_iters": 3}
    ds, jt, tt = _pair(jcfg, **kw)
    if policy == "plateau":
        jt._plateau["mult"] = tt._plateau["mult"] = 0.2
    params = p0 = jax.device_get(jt.params)
    rng = np.random.default_rng(0)
    for step in range(7):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape)
                                        * rng.choice([1e-9, 1e-3, 1.0])).astype(np.float32), params)
        updates, jt.opt_state = jt.optimizer.update(grads, jt.opt_state, params)
        mult = jt._plateau["mult"] if policy == "plateau" else 1.0
        params = jax.device_get(jax.tree.map(lambda p, u: p + u * mult, params, updates))
        g = dict(named_leaves(grads))
        for name, t in named_leaves(tt.params):
            t.grad = torch.as_tensor(g[name]) if t.requires_grad else None
        tt._apply_update()
        start = dict(named_leaves(p0))
        for name, v in named_leaves(params):
            t = dict(named_leaves(tt.params))[name].detach().numpy()
            ulp = 1.2e-7 * np.abs(start[name]).max()  # of the weight the move lands on
            np.testing.assert_allclose(t - start[name], v - start[name], rtol=2e-4,
                                       atol=2e-5 * LR * (step + 1) + 2 * ulp,
                                       err_msg=f"{step} {name}")
    got = adam_to_optax_leaves(tt.adam, tt.trainable, tt.schedule_count)
    want = _jax_opt_leaves(jt)
    assert len(got) == len(want) and int(got[0]) == int(want[0]) == 7
    assert int(got[-1]) == int(want[-1]) == 7
    for a, b in zip(got[1:-1], want[1:-1]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * np.abs(b).max())


def _jax_opt_leaves(jt):
    return [np.asarray(x) for x in jax.tree.leaves(jt.opt_state)]


def test_checkpoints_load_both_ways(tmp_path):
    """The sphere under 'plateau' with ``inverse`` frozen (58 of 78 optax
    leaves at the defaults' layer counts): every state of the optimizer,
    the counts, the step and the plateau controller cross both ways."""
    policy = "plateau"
    jcfg = _cfg("sphere")
    ds, jt, tt = _pair(jcfg, tmp_path, lr_policy=policy, freeze=["inverse"])
    for _ in range(2):
        _block(jt, tt, [ds.sample() for _ in range(2)])
    tt.save_networks("p", {"total_steps": 4})
    jt.save_networks("j", {"total_steps": 4})

    # the port's checkpoint in a fresh JAX trainer: every leaf arrives
    jt2 = JTrainer(jcfg, ds, lr=LR, niter=4, niter_decay=3, seed=5, save_dir=str(tmp_path),
                   lr_policy=policy, freeze=["inverse"])
    fresh = _jax_opt_leaves(jt2)
    meta = jt2.load_networks("p", str(tmp_path / "port"))
    assert meta["total_steps"] == 4 and jt2.step_count == 4
    mine = adam_to_optax_leaves(tt.adam, tt.trainable, tt.schedule_count)
    loaded = _jax_opt_leaves(jt2)
    assert len(loaded) == len(mine) == len(fresh)
    assert int(loaded[0]) == int(loaded[-1]) == 4
    for a, b in zip(loaded, mine):
        np.testing.assert_array_equal(a, b)
    assert any(np.abs(a).max() > 0 for a in loaded[1:-1])
    for name, v in named_leaves(jax.device_get(jt2.params)):
        np.testing.assert_array_equal(v, dict(named_leaves(tt.params))[name].detach().numpy())
    assert jt2._plateau == tt._plateau

    # the JAX checkpoint in a fresh port trainer
    tt2 = UVTrainer(tn.NeuTexConfig(**dataclasses.asdict(jcfg)), ds, lr=LR, niter=4,
                    niter_decay=3, seed=5, device="cpu", lr_policy=policy, freeze=["inverse"])
    meta = tt2.load_networks("j", str(tmp_path / "jax"))
    assert meta["total_steps"] == 4 and tt2.step_count == 4 and tt2.schedule_count == 4
    got = adam_to_optax_leaves(tt2.adam, tt2.trainable, tt2.schedule_count)
    for a, b in zip(got, _jax_opt_leaves(jt)):
        np.testing.assert_array_equal(a, np.asarray(b, a.dtype))
    assert tt2._plateau == jt._plateau

    # the next step from each loaded state matches the other package's step
    # from the state it loaded
    items = [ds.sample()]
    draws = _jax_draws(jt, 1)
    jt2.key = jt.key
    want = jt.train_block(items)
    want_2 = jt2.train_block(items)
    _assert_losses(want, tt2.train_block(items, draws=draws), 2e-3)
    _assert_losses(want_2, tt.train_block(items, draws=draws), 2e-3)

    # the JAX trainer's per-subnetwork files warm-start the port's; a
    # missing one is reported and skipped
    tt3 = UVTrainer(tn.NeuTexConfig(**dataclasses.asdict(jcfg)), ds, device="cpu",
                    save_dir=str(tmp_path / "jax"))
    tt3.load_subnetworks("j", ["gauge", "texture"])
    tt3.load_subnetworks("nonexistent", ["geometry"])
    for friendly, sub in (("gauge", "gauge_network"), ("texture", "net_texture")):
        with np.load(str(tmp_path / "jax" / f"j_subnet_{friendly}.npz")) as z:
            saved = {k[len("param/"):]: z[k] for k in z.files if k.startswith("param/")}
        for name, v in named_leaves(tt3.params[sub]):
            np.testing.assert_array_equal(v.detach().numpy(), saved[name])


TINY = ["--device", "cpu", "--dataset_name", "synthetic_dtu", "--random_sample", "balanced",
        "--random_sample_size", "4", "--sample_num", "8", "--primitive_type", "square",
        "--points_per_primitive", "16", "--synthetic_views", "4", "--synthetic_wh", "16",
        "--name", "sq", "--steps_per_call", "2", "--print_freq", "2", "--save_iter_freq", "0"]


def test_cli_sigterm_resume_and_test(tmp_path):
    """`uv_train_torch.py` in a subprocess, SIGTERMed once it has logged a
    step: it saves 'latest' at a block boundary and exits 0; the resume runs
    to --niter; `uv_test_torch.py` exports the texture and renders the test
    view with an edited texture."""
    from ngf_tpu_torch.utils.image import write_png

    ckpt = str(tmp_path / "ck")
    argv = TINY + ["--checkpoints_dir", ckpt]
    env = {**os.environ, "PYTHONUNBUFFERED": "1"}
    proc = subprocess.Popen([sys.executable, "uv_train_torch.py", *argv, "--niter", "100000"],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines = []
    try:
        deadline = time.time() + 120
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("End of iteration"):
                proc.send_signal(signal.SIGTERM)
                break
            assert time.time() < deadline, "".join(lines)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    lines.append(out)
    assert proc.returncode == 0, "".join(lines)
    assert "preempted at step" in out
    save_dir = os.path.join(ckpt, "sq")
    with np.load(os.path.join(save_dir, "latest_net_NeuTex.npz")) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        assert "extra/opt/0000" in z.files and "extra/torch_generator" in z.files
    stopped = meta["total_steps"]
    assert stopped >= 2 and stopped % 2 == 0

    import uv_test_torch
    import uv_train_torch

    uv_train_torch.main(argv + ["--niter", str(stopped + 4), "--resume_dir", save_dir])
    with np.load(os.path.join(save_dir, "latest_net_NeuTex.npz")) as z:
        assert json.loads(bytes(z["meta"]).decode())["total_steps"] == stopped + 4
    log = open(os.path.join(save_dir, "log.txt")).read()
    assert f"End of iteration {stopped + 4}" in log
    x = np.indices((32, 32)).sum(0) // 4 % 2
    tex = str(tmp_path / "checker.png")
    write_png(tex, (np.stack([x, 1 - x, x], -1) * 255).astype(np.uint8))
    uv_test_torch.main(argv + ["--target_texture", tex])
    outs = sorted(os.listdir(os.path.join(save_dir, "test_output")))
    assert outs == ["render-000.png", "texture.png", "transmittance-000.png"]


def test_chip_smoke_uv_phase_on_cpu(tmp_path, monkeypatch):
    """`chip_smoke.py`'s uv phase at a tiny size on the CPU: the K5 rows
    (plain version against itself), the SIGTERM and resume of the square
    run, the exports, the sphere and the bfloat16 runs, and its checks."""
    import chip_smoke

    out = chip_smoke.uv_phase(torch.device("cpu"), **chip_smoke.UV_CPU_REHEARSAL)
    assert {r["case"] for r in out["k5"]} >= {"train step", "render chunk"}
    assert set(out["runs"]) == {"square float32", "sphere float32", "square bfloat16"}
    sq = out["runs"]["square float32"]
    assert sq["resumed_from"] > 0 and np.isfinite(sq["novel_psnr_db"])
    assert 0.0 <= sq["novel_iou"] <= 1.0
