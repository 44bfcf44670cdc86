"""The comparison that decides ``correct``, at a size the CPU holds: a run of
each cell with the port as it is comes out correct; the control (the plain
reference in TF32 in the program's place) does not; nor does a run with the
timed path broken underneath by each fault the cell can have: a step that
leaves its state unchanged, half of the batch left out with the mean taken
over the rest, an answer altered where it is produced. (One chip: no
exchange between chips to leave out.) Nor does a run whose gauge crops
its planes one voxel off or resizes them with the other corner
convention. The chip's look for a card is skipped; the rest of the run is
the harness's own."""

import time

import pytest
import torch

from gpubench import harness
from gpubench.reference import check
from gpubench.tests.tiny import tiny_spec
from ngf_tpu_torch.fields import triplane
from ngf_tpu_torch.train import loop, state

SEED = 3000000019
TRAIN = ["infoinv-lego.train", "gauge-lego.train"]
RENDER = ["infoinv-lego.render", "gauge-lego.render"]


def _run(cell):
    sp = tiny_spec(cell)
    run = sp.driver.run(sp, SEED, 0.5, False, torch.device("cpu"), time.perf_counter())
    return sp, run


@pytest.mark.parametrize("cell", TRAIN + RENDER)
def test_the_port_is_correct_and_the_control_is_not(cell):
    sp, run = _run(cell)
    numbers = sp.driver.check(sp, run)
    assert harness.judge(numbers), numbers
    train = cell in TRAIN
    sides = (check.train_sides if train else check.render_sides)(sp, run, control=True)
    compare = check.compare_train if train else check.compare_render
    control = check.numbers(compare(sides["control"], sides["reference"]), sp.workload["limits"])
    assert not harness.judge(control), control


def _frozen(monkeypatch):
    monkeypatch.setattr(state.TriPlaneOptimizer, "step", lambda self: None)


def _half(monkeypatch):
    grads = loop.TriPlaneTrainer.compute_grads

    def half(self, rays, rgbs, *a, **kw):
        n = rays.shape[0] // 2
        return grads(self, rays[:n], rgbs[:n], *a, **kw)

    monkeypatch.setattr(loop.TriPlaneTrainer, "compute_grads", half)


def _render_fault(monkeypatch, kind):
    render = loop.render_rays

    def broken(*a, **kw):
        out = dict(render(*a, **kw))
        rgb = out["rgb_map"]
        if kind == "altered":
            rgb = rgb + torch.nn.functional.pad(torch.full((1, 1), 0.25), (0, 2, 0, rgb.shape[0] - 1))
        else:
            rgb = torch.cat([rgb[: rgb.shape[0] // 2], torch.zeros_like(rgb[rgb.shape[0] // 2:])])
        out["rgb_map"] = rgb
        return out

    monkeypatch.setattr(loop, "render_rays", broken)


FAULTS = {
    "state unchanged": _frozen,
    "half the batch": _half,
    "an answer altered": lambda mp: _render_fault(mp, "altered"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", TRAIN)
def test_a_broken_train_step_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    sp, run = _run(cell)
    assert not harness.judge(sp.driver.check(sp, run))


@pytest.mark.parametrize("fault", ["half", "altered"])
@pytest.mark.parametrize("cell", RENDER)
def test_a_broken_render_is_not_correct(cell, fault, monkeypatch):
    _render_fault(monkeypatch, fault)
    sp, run = _run(cell)
    assert not harness.judge(sp.driver.check(sp, run))


def _crop_off(monkeypatch):
    crop = loop.shrink_planes
    monkeypatch.setattr(loop, "shrink_planes", lambda params, t_l, b_r: crop(params, t_l + 1, b_r + 1))


def _resize_corners(monkeypatch):
    def resize(params, res):
        rx, ry, rz = (int(v) for v in res)
        out = dict(params)
        for name, hw in (("plane_xy", (ry, rx)), ("plane_yz", (rz, ry)), ("plane_xz", (rz, rx))):
            img = params[name].permute(2, 0, 1)[None]
            out[name] = torch.nn.functional.interpolate(
                img, size=hw, mode="bilinear", align_corners=False)[0].permute(1, 2, 0).contiguous()
        return out

    monkeypatch.setattr(loop, "upsample_planes", resize)


RESAMPLE_FAULTS = {"crop one voxel off": _crop_off, "resize with the other corners": _resize_corners}


@pytest.mark.parametrize("fault", list(RESAMPLE_FAULTS))
@pytest.mark.parametrize("cell", ["gauge-lego.train", "gauge-lego.render"])
def test_a_wrong_crop_or_resize_of_the_planes_is_not_correct(cell, fault, monkeypatch):
    assert loop.upsample_planes is triplane.upsample_planes
    RESAMPLE_FAULTS[fault](monkeypatch)
    sp, run = _run(cell)
    numbers = sp.driver.check(sp, run)
    assert numbers["planes_differ"]["value"] > 0
    assert not harness.judge(numbers)
