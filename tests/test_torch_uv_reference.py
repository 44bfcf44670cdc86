"""The port's UV trainer against the benchmark's plain NeuTex reference
(`gpubench/reference/neutex.py`) on the CPU at a tiny width, and the parts of
the trainer that the `uv-dtu.train` cell runs:

- three `UVTrainer` steps on seeded random weights with injected draws: the
  forward's uv, colour and transmittance, each loss term, every leaf's
  gradient and the change of each of three Adam steps, for the square and the
  sphere, with and without the inverse-mapping term; each step from the
  port's state before it, as the cell's check does (`reference/uv_check.py`):
  the gauge network's gradient is too sensitive to its parameters for two
  trajectories to stay together; a planted fault (uv cut from the gauge
  network before the texture) fails the same comparison;
- the balanced sampler on its cached pixel lists draws what a scan of the
  mask on every call drew (`px`, `py`, `trans`) on a non-square mask;
- `UVTrainer.run` trains through `train_block`: its losses over a block are
  `train_block`'s, and so are the parameters after it;
- tracing: a traced and an untraced run end in the same state; the spans
  and counters are there when tracing is on and absent when it is off.

Tolerances: both sides run the same float32 operations on the CPU, the
port's K5 as its plain version (a reverse scan in the backward against the
reference's autograd of a cumprod), so the forward agrees to 1e-6 of each
output's largest value and gradients to 1e-5 of each leaf's largest, the change of
each Adam step by its norm to 1e-4 (the test's comment says why); the fault
moves the gauge network's gradient by its whole size.
"""

import numpy as np
import pytest
import torch

from gpubench.drivers import uv_train as D
from gpubench.reference import check
from gpubench.reference import neutex as N
from gpubench.reference.model import flatten
from ngf_tpu_torch.data.dtu import SyntheticDtuDataset
from ngf_tpu_torch.fields import neutex
from ngf_tpu_torch.fields.neutex import NeuTexConfig
from ngf_tpu_torch.train.uv_loop import UVTrainer
from ngf_tpu_torch.utils import profiling

TINY = dict(sample_num=8, points_per_primitive=24, geo_hidden=16, geo_layers=2, tex_width=16,
            tex_layers1=2, tex_layers2=1, gauge_mid=8, gauge_hidden=12, gauge_layers=1,
            inverse_mid=8, inverse_hidden=24, inverse_layers=1)


def _dataset(seed=4, views=3, wh=(20, 14), size=4):
    return SyntheticDtuDataset(n_views=views, wh=wh, random_sample="balanced",
                               random_sample_size=size, seed=seed)


def _trainer(primitive, w_inv, seed=7, **kw):
    cfg = NeuTexConfig(primitive_type=primitive, **TINY)
    weights = {"color": 1.0, "bg": 1.0, "origin": 1.0, "inverse_mapping": w_inv}
    tr = UVTrainer(cfg, kw.pop("dataset", None), lr=1e-3, loss_weights=weights, seed=seed,
                   device="cpu", **kw)
    # Random biases (the initialiser zeroes them) and an inverse network
    # whose template points reach past the unit ball, so that every term
    # and every leaf takes a gradient.
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in flatten(tr.params).items():
            if name.endswith("/b"):
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
        last = tr.params["inverse_network"]["layers"][-1]
        last["w"].mul_(8.0)
    return tr


def _ucfg(cfg: NeuTexConfig, w_inv: float, lr: float) -> N.UVCfg:
    return N.UVCfg(primitive=cfg.primitive_type, sample_num=cfg.sample_num, jitter=cfg.jitter,
                   geo_freqs=cfg.geo_freqs, tex_freqs=cfg.tex_freqs, view_freqs=cfg.view_freqs,
                   w_color=1.0, w_bg=1.0, w_origin=1.0, w_inverse=w_inv, lr=lr, niter=500000,
                   niter_decay=0)


def _draws(tr, n, rays, seed=11):
    g = torch.Generator().manual_seed(seed)
    return [{"u": torch.rand((1, rays, tr.cfg.sample_num), generator=g),
             "template": N.template_points(g, tr.cfg.points_per_primitive, tr.cfg.primitive_type)}
            for _ in range(n)]


def _batch(item, d):
    f = lambda k: torch.as_tensor(item[k][0])  # noqa: E731
    return {"campos": f("campos"), "raydir": f("raydir"), "gt": f("gt_image"),
            "background": f("background_color"), "trans": f("transmittance"),
            "u": d["u"][0], "template": d["template"]}


def _program_steps(tr, items, draws):
    """The port's steps: each step's gradient, and its state (parameters,
    Adam's moments and counts) before the first step and after each."""
    grads, states = [], [(D.snapshot_params(tr), None)]
    update = tr._apply_update

    def recorded():
        grads.append({k: v.grad.detach().clone() for k, v in flatten(tr.params).items()})
        update()

    tr._apply_update = recorded
    losses = tr.train_block(items, draws, progress_cb=lambda step: states.append(
        (D.snapshot_params(tr), D.snapshot_adam(tr))))
    tr._apply_update = update
    return losses, grads, states


def _reference(states, batches, ucfg):
    """The reference's step from each of the port's states before a step."""
    out = []
    for (p, adam), b in zip(states, batches):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        fwd = N.forward(leaves, ucfg, b["campos"], b["raydir"], b["background"], b["u"],
                        b["template"])
        total, terms = N.losses(fwd, ucfg, b["gt"], b["trans"])
        out.append({"terms": {k: float(v.detach()) for k, v in terms.items()},
                    "total": float(total.detach())})
    got = N.steps(states[:len(batches)], batches, ucfg)
    for o, g, c in zip(out, got["g"], got["change"]):
        o.update(grads=g, change=c)
    return out


def _close(got, want, rel):
    got, want = torch.as_tensor(got, dtype=torch.float64), torch.as_tensor(want, dtype=torch.float64)
    scale = max(float(want.abs().max()), 1e-12)
    return float((got - want).abs().max()) <= rel * scale


@pytest.mark.parametrize("primitive", ["square", "sphere"])
@pytest.mark.parametrize("w_inv", [0.0, 0.5])
def test_trainer_steps_match_the_reference(primitive, w_inv):
    ds = _dataset()
    tr = _trainer(primitive, w_inv)
    items = [ds.sample() for _ in range(3)]
    draws = _draws(tr, 3, items[0]["raydir"].shape[1])
    p0 = {k: v.detach().clone() for k, v in flatten(tr.params).items()}
    ucfg = _ucfg(tr.cfg, w_inv, 1e-3)
    batches = [_batch(it, d) for it, d in zip(items, draws)]

    # The forward at the initial weights.
    with torch.no_grad():
        b = batches[0]
        got = neutex.neutex_forward(tr.params, tr.cfg, b["campos"][None], b["raydir"][None],
                                    b["background"][None], u=draws[0]["u"],
                                    template=draws[0]["template"], inverse=w_inv > 0)
        want = N.forward(p0, ucfg, b["campos"], b["raydir"], b["background"], b["u"], b["template"])
    assert _close(got["uv"][0], want["uv"], 1e-6)
    assert _close(got["color"][0], want["color"], 1e-6)
    assert _close(got["transmittance"][0], want["transmittance"], 1e-6)
    assert _close(got["points"][0].t(), want["points"], 1e-6)

    losses, grads, states = _program_steps(tr, items, draws)
    ref = _reference(states, batches, ucfg)
    names = {"color", "bg", "origin"} | ({"inverse_mapping"} if w_inv > 0 else set())
    assert set(losses) == names | {"total"}
    assert ref[0]["terms"]["origin"] > 0
    for t in range(3):
        for k in names:
            assert abs(losses[k][t] - ref[t]["terms"][k]) <= 1e-5 * abs(ref[t]["terms"][k]) + 1e-9, (t, k)
        assert abs(losses["total"][t] - ref[t]["total"]) <= 1e-5 * ref[t]["total"]
        # Every leaf's gradient, and the change of every leaf, at each step
        # from the port's state before it. The change by its norm, as the
        # cell compares it, to 1e-4: Adam divides each element's moment by
        # its root mean square, so an element whose gradient is a sum that
        # cancels to near 0 moves by a share of the rate that follows the
        # sum's rounding (read up to 1.9e-5 here, 1.9e-5 on the card).
        for k, g in ref[t]["grads"].items():
            assert float(g.abs().max()) > 0, (t, k)
            assert _close(grads[t][k], g, 1e-5), (t, k)
        change = {k: states[t + 1][0][k] - states[t][0][k] for k in states[t][0]}
        assert check.leaf_gap(change, ref[t]["change"]) <= 1e-4, t


def test_a_detached_uv_fails_the_comparison(monkeypatch):
    ds = _dataset()
    tr = _trainer("square", 0.5)
    items = [ds.sample()]
    draws = _draws(tr, 1, items[0]["raydir"].shape[1])
    p0 = {k: v.detach().clone() for k, v in flatten(tr.params).items()}
    texture = neutex.apply_texture_mlp
    monkeypatch.setattr(neutex, "apply_texture_mlp",
                        lambda p, cfg, uv, *a, **kw: texture(p, cfg, uv.detach(), *a, **kw))
    _, grads, states = _program_steps(tr, items, draws)
    ref = _reference(states, [_batch(items[0], draws[0])], _ucfg(tr.cfg, 0.5, 1e-3))
    gauge = [k for k in p0 if k.startswith("gauge_network/")]
    assert not all(_close(grads[0][k], ref[0]["grads"][k], 1e-5) for k in gauge)
    assert all(_close(grads[0][k], ref[0]["grads"][k], 1e-5) for k in p0
               if k.startswith("net_geometry"))


def _where_select(ds, view):
    """The balanced draw as a scan of the mask on every call made it."""
    s, mask = ds.random_sample_size, ds.gt_mask[view]
    fg_yx = np.stack(np.where(mask > 0), 1)
    bg_yx = np.stack(np.where(mask == 0), 1)
    n_fg = min(int(s * s * 2.0 / 3.0), fg_yx.shape[0])
    n_bg = s * s - n_fg
    fi = ds._rng.integers(0, fg_yx.shape[0], n_fg)
    trans = np.zeros(n_fg + n_bg, np.float32)
    if bg_yx.shape[0] == 0:
        bg_yx = fg_yx
        bi = ds._rng.integers(0, fg_yx.shape[0], n_bg)
    else:
        bi = ds._rng.integers(0, bg_yx.shape[0], n_bg)
        trans[n_fg:] = 1.0
    px = np.concatenate([fg_yx[fi, 1], bg_yx[bi, 1]]).astype(np.float32)
    py = np.concatenate([fg_yx[fi, 0], bg_yx[bi, 0]]).astype(np.float32)
    return px, py, trans


def test_the_cached_pixel_lists_draw_what_a_scan_drew():
    a, b = _dataset(seed=9, wh=(23, 11), size=5), _dataset(seed=9, wh=(23, 11), size=5)
    rng = np.random.default_rng(2)
    masks = (rng.random(a.gt_mask.shape) < 0.4).astype(np.float32)
    masks[1] = 1.0  # a view without background
    for d in (a, b):
        d.gt_mask = masks.copy()
        d._build_pixel_lists()
    assert all(v in a._lists for v in a.indexes)
    for _ in range(12):
        view = int(a._rng.integers(len(a.indexes)))
        assert view == int(b._rng.integers(len(b.indexes)))
        got, want = a._proportional_select(view), _where_select(b, view)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_run_trains_through_train_block(tmp_path):
    a = _trainer("square", 0.5, dataset=_dataset(seed=3), niter=6, save_dir=str(tmp_path / "a"))
    b = _trainer("square", 0.5, dataset=_dataset(seed=3))
    steps = []
    out = a.run(steps_per_call=6, print_freq=0, test_freq=0, save_iter_freq=0,
                progress_cb=steps.append)
    want = b.train_block([b.dataset.sample() for _ in range(6)])
    assert steps == [1, 2, 3, 4, 5, 6] and out["total_steps"] == 6 and not out["preempted"]
    assert set(out["losses"]) == set(want)
    for k in want:
        np.testing.assert_array_equal(out["losses"][k], want[k])
    for k, v in flatten(a.params).items():
        torch.testing.assert_close(v, flatten(b.params)[k], rtol=0, atol=0)
    assert (tmp_path / "a" / "latest_net_NeuTex.npz").is_file()


def _fresh_report(tmp_path):
    with profiling.trace(str(tmp_path / "empty")):
        pass
    profiling.report()


def test_tracing_changes_no_state_and_records_the_spans(tmp_path):
    _fresh_report(tmp_path)
    plain = _trainer("square", 0.5, dataset=_dataset(seed=5), niter=4)
    plain.run(steps_per_call=2, print_freq=0, test_freq=0, save_iter_freq=0)
    rep = profiling.report()
    assert rep["spans"] == {} and rep["counters"] == {}

    traced = _trainer("square", 0.5, dataset=_dataset(seed=5), niter=4)
    with profiling.trace(str(tmp_path / "tb")):
        traced.run(steps_per_call=2, print_freq=0, test_freq=0, save_iter_freq=0)
    rep = profiling.report()
    for k, v in flatten(plain.params).items():
        torch.testing.assert_close(flatten(traced.params)[k], v, rtol=0, atol=0)
    spans = rep["spans"]
    per_step = ("ngf.step", "ngf.forward", "ngf.field", "ngf.uv.geometry", "ngf.uv.gauge",
                "ngf.uv.texture", "ngf.uv.inverse", "ngf.render.composite", "ngf.backward")
    for name in per_step:
        assert spans[name]["count"] == 4 and spans[name]["ids"] == 4, name
    # A step's zero_grad and update are two regions.
    assert spans["ngf.optimizer"]["count"] == 8
    assert spans["ngf.batch"]["count"] == 2 and spans["ngf.log"]["count"] == 2
    assert spans["ngf.field"]["parents"] == ["ngf.forward"]
    assert spans["ngf.uv.inverse"]["parents"] == ["ngf.field"]
    assert spans["ngf.render.composite"]["parents"] == ["ngf.forward"]
    assert spans["ngf.forward"]["parents"] == ["ngf.step"]
    rays = 4 * 4
    cfg = traced.cfg
    assert rep["counters"] == {"rays": 4 * rays, "slots": 4 * rays * cfg.sample_num,
                               "template": 4 * cfg.points_per_primitive}
