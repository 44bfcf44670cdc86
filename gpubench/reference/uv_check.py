"""What decides ``correct`` in a UV cell: the program's steps against the
plain NeuTex reference (`reference/neutex.py`), at the timed sizes, once the
window has closed.

Two sets of three steps. ``open``: the first three steps from the seed,
from the program's initial weights. ``window``: the window's first three
steps. Each step starts from the program's state before it (its
parameters and Adam state, copied on the device after each step), so the
reference repeats each step and not a trajectory: the gauge network's
gradient follows uv through PE(uv) at frequencies up to 2^9 into a
piecewise-linear texture network, and a relative change of 1e-7 in the
parameters moves it by about 1% (measured on the card, `PERF.md` §2), so
two trajectories part within three Adam steps whatever their precision.
Each step takes the program's own batch (the item its sampler gave that
step, recorded on the host) and its own draws (the jitter and the
template points, drawn again by the reference from the trainer's
generator state recorded before its first step: each step draws its
jitter, then its template points). Compared, each by the worst of the
three steps and the worst leaf: the loss (``loss_gap``, relative), the
gradient as Adam got it (from its first moments before and after the
step: m1 = 0.9 m0 + 0.1 g) and the change of the parameters
(``change_gap``, over the leaves that the reference's gradient moves).

A side is one set of readings: the program's, the reference's, the
reference in TF32 in the program's place (the control) or with a fault
planted (``detach``: the texture reads uv cut from the gauge network;
``no_inverse``: the inverse-mapping term dropped; ``half``: half of each
batch's rays).
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference import check
from gpubench.reference import neutex as N

FAULTS = ("detach", "no_inverse", "half")


def draws(state: torch.Tensor, device, rays: int, samples: int, points: int, primitive: str,
          first: int, n: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The (jitter (rays, samples), template) draws of steps ``first`` ..
    ``first + n - 1`` (0-based) from a generator on ``device`` at ``state``."""
    g = torch.Generator(device=device)
    g.set_state(state)
    out = []
    for k in range(first + n):
        u = torch.rand((1, rays, samples), generator=g, device=device)
        t = N.template_points(g, points, primitive)
        if k >= first:
            out.append((u[0], t))
    return out


def batches(run: dict, first: int, n: int, device) -> list[dict]:
    """The reference's batches of steps ``first`` .. ``first + n - 1``: the
    program's items and the draws again."""
    a = run["config"]["args"]
    items = [run["items"][k] for k in range(first, first + n)]
    R = items[0]["raydir"].shape[1]
    ds = draws(run["gen_state"], device, R, a["sample_num"], a["points_per_primitive"],
               a["primitive_type"], first, n)
    out = []
    for it, (u, t) in zip(items, ds):
        f = lambda k: torch.as_tensor(it[k][0], device=device)  # noqa: E731
        out.append({"campos": f("campos"), "raydir": f("raydir"), "gt": f("gt_image"),
                    "background": f("background_color"),
                    "trans": f("transmittance") if "transmittance" in it else None,
                    "u": u, "template": t})
    return out


def _states(run: dict, first: int, n: int) -> list[tuple[dict, dict | None]]:
    """The program's (parameters, Adam state) before steps ``first + 1`` ..
    ``first + n + 1``: its initial state for the first step of a run."""
    s = run["snaps"]

    def adam(k):
        a = s[k]["adam"]
        return dict(a, t={name: int(t) for name, t in a["t"].items()})

    out = [(run["init"], None) if first == 0 else (s[first]["p"], adam(first))]
    return out + [(s[k]["p"], adam(k)) for k in range(first + 1, first + n + 1)]


def _program(losses: np.ndarray, states: list, n: int, first: int) -> dict:
    out = {"mse": [float(v) for v in losses[first:first + n]], "g": [], "change": []}
    for (p0, a0), (p1, a1) in zip(states[:n], states[1:]):
        out["g"].append({k: (a1["m"][k] - (0.9 * a0["m"][k] if a0 else 0.0)) / 0.1 for k in p1})
        out["change"].append({k: p1[k] - p0[k] for k in p1})
    return out


def sides(spec, run: dict, control: bool = False, faults: tuple = ()) -> dict:
    """The program's side and the reference's (and the control's and each
    fault's, when asked)."""
    N.no_tf32()
    n, W = spec.traffic["checked_steps"], run["warm_end"]
    device = next(iter(run["init"].values())).device
    parts = {"open": 0, "window": W}
    states = {part: _states(run, first, n) for part, first in parts.items()}
    prog = {part: _program(run["losses"], states[part], n, first) for part, first in parts.items()}
    data = {part: batches(run, first, n, device) for part, first in parts.items()}

    def side(tf32: bool, fault: str | None) -> dict:
        cfg = N.UVCfg.from_config(spec.config, tf32)
        return {part: N.steps(states[part][:n], data[part], cfg, fault) for part in parts}

    out = {"program": prog, "reference": side(False, None)}
    if control:
        out["control"] = side(True, None)
    for f in faults:
        out[f] = side(False, f)
    return out


def compare(prog: dict, ref: dict) -> dict:
    out = {}
    for part in ("open", "window"):
        p, r = prog[part], ref[part]
        out[f"{part}_loss_gap"] = max(abs(a - b) / abs(b) for a, b in zip(p["mse"], r["mse"]))
        out[f"{part}_grad_gap"] = max(check.leaf_gap(a, b) for a, b in zip(p["g"], r["g"]))
        out[f"{part}_change_gap"] = max(check.leaf_gap(a, b, check.moved_leaves(g))
                                        for a, b, g in zip(p["change"], r["change"], r["g"]))
    return out


def numbers(spec, run: dict) -> dict:
    got = sides(spec, run)
    run["readings"] = compare(got["program"], got["reference"])
    return check.numbers(run["readings"], spec.workload["limits"])
