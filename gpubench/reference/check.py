"""What decides ``correct``: the program's outputs against the plain
reference, at the timed sizes, once the window has closed and the program's
state is freed.

A side is one set of readings: the program's, the reference's, or the
reference put in the program's place in a lower precision (the control) or
with a fault planted (``fault``). :func:`compare` turns two sides into the
numbers each limit holds.

Training cells. The reference works out again, from the same scene and the
same seed, the box filter of the rays, the first three steps from the
seed's weights (its own sampler over its own kept rays, its own jitter
stream), and each mask event from the parameters the program held when it
fired (the grid, the tight box, the gauge's crop and upsampled grid, the
sample count, the capacity from the same 65,536-ray subsample, and on a
sample of the rays whether each touches occupied space). The gauge's crop
and each resize of its planes are done again from the program's
parameters just before them and compared value for value. The reference
cannot repeat the hundreds of open steps between, so the first three
masked steps after the last event, and the window's first three steps,
start from the program's parameters and optimizer state there, and use
the reference's own grid, box, capacity, sampler and jitter. Compared:
each step's loss, the first gradient as the optimizer got it (from its
first moment), and the parameters' change over the three steps, each by
the worst leaf.

Render cells. The reference renders a sample of the chunks that the window
rendered, drawn from the seed, from the program's trained parameters with
its own grid, box and sample count: the rgb and depth are compared; the
events and the planes' crop and resizes as in training.

A traced run also counts, with the reference's front end and density,
the samples in the box and the mask and the samples shaded over every
step or chunk of the window: the work that the per-layer rooflines and
``mfu`` count.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference import model as M
from gpubench.scene.synthetic import near_blobs

BLOCK = 1024
KEPT_SAMPLE = 262144
CAP_SAMPLE = 65536


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        parts = name.split("/")
        node = tree
        for i, p in enumerate(parts[:-1]):
            nxt = parts[i + 1]
            key = int(p) if isinstance(node, list) else p
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = [] if nxt.isdigit() else {}
                node = node[key]
            else:
                node = node.setdefault(p, [] if nxt.isdigit() else {})
        last = parts[-1]
        if isinstance(node, list):
            while len(node) <= int(last):
                node.append(None)
            node[int(last)] = t
        else:
            node[last] = t
    return tree


# ---------------------------------------------------------------- geometry

def _bool_of(ids: np.ndarray, n: int, device) -> torch.Tensor:
    m = torch.zeros(n, dtype=torch.bool, device=device)
    m[torch.as_tensor(np.asarray(ids), device=device)] = True
    return m


def bbox_keep(scene, device) -> torch.Tensor:
    aabb = torch.tensor(np.asarray(scene.scene_bbox), device=device)
    out = []
    for i in range(0, scene.rays.shape[0], 1 << 22):
        r = scene.rays[i:i + (1 << 22)]
        t_min, t_max = M.ray_aabb_range(r[:, :3], r[:, 3:6], aabb)
        out.append(t_max > t_min)
    return torch.cat(out)


def geometry(cfg: dict, scene, events: list[dict], kept_ids: np.ndarray, tf32: bool = False) -> dict:
    """The reference's mask, box, step, sample count and capacity after the
    configuration's events, each mask from the parameters the program held
    when it fired, and the ``plan`` of the planes' crop and resizes (kind,
    iteration, voxel box or grid). ``kept_ids`` (the program's kept rays,
    which the kept sample checks) orders the capacity's subsample."""
    a, w = cfg["args"], cfg["widths"]
    fc = M.FieldCfg.from_config(cfg, tf32)
    ratio = a["step_ratio"]
    aabb = np.asarray(scene.scene_bbox, np.float32)
    grid = M.n_to_reso(w["plane_res"] ** 3, aabb)
    step = M.step_size(aabb, grid, ratio)
    n_samples = min(a["nSamples"], M.cal_n_samples(grid, ratio))
    masks = list(a.get("update_AlphaMask_list", []))
    ups = list(a.get("upsamp_list", [])) if a["subsystem"] == "triplane" else []
    voxels = M.voxel_schedule(a["N_voxel_init"], a["N_voxel_final"], len(ups))
    prev, out = None, {"masks": [], "ints": [], "plan": []}
    l1 = a["L1_weight_initial"]
    for it in sorted(set(masks) | set(ups)):
        if it in masks:
            ev = next(e for e in events if e["iteration"] == it)
            vol, vol_aabb, box = M.alpha_mask(unflatten(ev["params"]), fc, aabb,
                                              a["alpha_mask_len"] or step, w["alpha_grid_res"],
                                              a["alpha_mask_thre"], prev)
            out["masks"].append(vol)
            out["ints"] += [float(v) for v in box.reshape(-1)]
            if prev is None:
                l1 = a["L1_weight_rest"]
                if a["subsystem"] == "triplane":
                    t_l, b_r = M.shrink_voxels(aabb, box, grid)
                    out["ints"] += [int(v) for v in (*t_l, *b_r)]
                    out["plan"].append(("crop", it, (t_l, b_r)))
                    aabb, grid = box.astype(np.float32), [int(v) for v in b_r - t_l]
                    step = M.step_size(aabb, grid, ratio)
                out["filter"] = (aabb.copy(), step)
            prev = (vol, vol_aabb)
        if it in ups:
            grid = M.n_to_reso(voxels.pop(0), aabb)
            out["plan"].append(("resize", it, grid))
            n_samples = min(a["nSamples"], M.cal_n_samples(grid, ratio))
            step = M.step_size(aabb, grid, ratio)
    near, far = scene.near_far
    cap = a.get("masked_sample_cap") or None
    if prev is not None and a["sample_cap"] == -1 and cap is None:
        pos = np.arange(len(kept_ids))
        if len(kept_ids) > CAP_SAMPLE:
            pos = np.random.default_rng(0).choice(len(kept_ids), CAP_SAMPLE, replace=False)
        ids = torch.as_tensor(np.asarray(kept_ids)[pos], device=scene.rays.device)
        counts = M.occupied_counts(scene.rays[ids], prev[0], prev[1], aabb, near, far, step,
                                   n_samples)
        cap = M.auto_cap(counts, n_samples)
    out.update(aabb=aabb, grid=grid, step=step, n_samples=n_samples, cap=cap, volume=prev,
               l1=l1)
    out["ints"] += [*grid, n_samples, step, -1 if cap is None else cap]
    return out


def program_ints(geom: dict) -> list:
    """The program's counterpart of :func:`geometry`'s ``ints``."""
    out = []
    for ev in geom["events"]:
        rec = ev["rec"]
        out += [float(v) for v in np.asarray(rec["new_aabb"], np.float32).reshape(-1)]
        if "shrink" in rec:
            out += [int(v) for v in (*rec["shrink"]["t_l"], *rec["shrink"]["b_r"])]
    out += [*geom["grid"], geom["n_samples"], geom["step"], geom["cap"]]
    return out


def resampled(plan: list, events: list[dict], records: list[dict], fault: str | None = None) -> list:
    """The reference's parameters after each crop and resize of ``plan``:
    the crop from the parameters that the program's mask event read, a
    resize from the program's parameters just before it (None where the
    program has no such event). ``fault``: the planes left unchanged
    (``frozen``) or one value altered (``altered``)."""
    out = []
    for kind, it, arg in plan:
        if kind == "crop":
            before = next(e["params"] for e in events if e["iteration"] == it)
            after = M.crop_planes(before, *arg)
        else:
            rec = next((r for r in records if r["kind"] == kind and r["iteration"] == it), None)
            if rec is None:
                out.append((kind, it, None))
                continue
            before = rec["before"]
            after = M.resize_planes(before, arg)
        if fault == "frozen":
            after = before
        elif fault == "altered" and not out:
            after = dict(after, plane_xy=after["plane_xy"] + _one_value(after["plane_xy"], 0.25))
        out.append((kind, it, after))
    return out


def planes_differ(prog: list, ref: list) -> float:
    """Parameter values that differ, bit for bit, between the program's and
    the reference's leaves after each crop and resize; every value of an
    event or leaf that one side lacks or gives another shape."""
    p_by, r_by = {(k, it): t for k, it, t in prog}, {(k, it): t for k, it, t in ref}
    n = 0
    for key in p_by.keys() | r_by.keys():
        p, r = p_by.get(key), r_by.get(key)
        if p is None or r is None:
            n += sum(v.numel() for v in (p or r or {"": torch.ones(1)}).values())
            continue
        for name in p.keys() | r.keys():
            x, y = p.get(name), r.get(name)
            if x is None or y is None or x.shape != y.shape:
                n += max(t.numel() for t in (x, y) if t is not None)
            else:
                n += int((x != y).sum())
    return float(n)


def kept_sample(scene, seed: int, bbox_ids: np.ndarray) -> torch.Tensor:
    """Dataset ids of the rays whose kept status is checked: a sample of the
    box-kept rays drawn from the seed."""
    n = min(KEPT_SAMPLE, len(bbox_ids))
    pick = np.random.default_rng(seed).choice(len(bbox_ids), n, replace=False)
    return torch.as_tensor(np.asarray(bbox_ids)[np.sort(pick)], device=scene.rays.device)


def touches_sample(scene, ids: torch.Tensor, geo: dict) -> torch.Tensor:
    aabb, step = geo["filter"]
    near, far = scene.near_far
    return M.touches(scene.rays[ids], geo["volume"][0], geo["volume"][1], aabb, near, far, step)


# ------------------------------------------------------------------- steps

def _render_cfg(cfg: dict, scene, geo_like: dict, cap: int | None) -> M.RenderCfg:
    a = cfg["args"]
    G = a["group_size"]
    S = geo_like["n_samples"]
    ng = -(-S // G)
    capg = ng if not cap else min(ng, -(-cap // G))
    return M.RenderCfg(aabb=tuple(map(tuple, np.asarray(geo_like["aabb"], np.float32).tolist())),
                       near=float(scene.near_far[0]), far=float(scene.near_far[1]), n_samples=S,
                       step_size=geo_like["step"], group=G, capg=capg,
                       distance_scale=a["distance_scale"], thres=a["rm_weight_mask_thre"])


def steps(cfg: dict, scene, params: dict, adam_state: dict | None, batches: list, rc: M.RenderCfg,
          volume, l1: float, tf32: bool = False, fault: str | None = None) -> dict:
    """Reference steps from ``params`` (flat) and ``adam_state`` (None: a new
    optimizer). ``batches``: (dataset ids, jitter (B, 1), iteration) a step.
    Returns each step's MSE, the first step's gradient and the parameters'
    change, all flat by leaf."""
    a = cfg["args"]
    fc = M.FieldCfg.from_config(cfg, tf32)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    tree = unflatten(leaves)
    if adam_state is not None:
        adam_state = {"count": adam_state["count"], "t": dict(adam_state["t"]),
                      "m": {k: v.clone() for k, v in adam_state["m"].items()},
                      "v": {k: v.clone() for k, v in adam_state["v"].items()}}
    decay = a["lr_decay_iters"] if a["lr_decay_iters"] > 0 else a["n_iters"]
    opt = M.Adam(leaves, a["lr_init"], a["lr_basis"], a["lr_decay_target_ratio"], decay, adam_state)
    vol, vol_aabb = (None, None) if volume is None else volume
    out = {"mse": [], "g1": None}
    for ids, jitter, it in batches:
        rays, rgbs = scene.rays[ids], scene.rgbs[ids]
        if fault == "half":
            h = rays.shape[0] // 2
            rays, rgbs, jitter = rays[:h], rgbs[:h], jitter[:h]
        B = rays.shape[0]
        for p in leaves.values():
            p.grad = None
        sse = 0.0
        for b in range(0, B, BLOCK):
            rgb, _ = M.render(tree, fc, rc, rays[b:b + BLOCK], it, vol, vol_aabb,
                              jitter[b:b + BLOCK])
            if fault == "altered" and b == 0:
                rgb = rgb + _one_value(rgb, 0.25)
            se = ((rgb - rgbs[b:b + BLOCK]) ** 2).sum()
            (se / (B * 3)).backward()
            sse += float(se.detach())
        (l1 * M.density_l1(tree)).backward()
        out["mse"].append(sse / (B * 3))
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in leaves.items()}
        if out["g1"] is None:
            out["g1"] = {k: g.detach().clone() for k, g in grads.items()}
        if fault != "frozen":
            opt.step(grads)
    out["change"] = {k: (leaves[k].detach() - params[k]) for k in leaves}
    return out


def _one_value(x: torch.Tensor, v: float) -> torch.Tensor:
    d = torch.zeros_like(x)
    d.view(-1)[0] = v
    return d


def sampler_ids(total: int, batch: int, seed: int, first: int, n: int) -> list[np.ndarray]:
    """Batches ``first`` .. ``first + n - 1`` (0-based) of the epoch sampler
    (`InfoInv/utils.py` SimpleSampler): a permutation of ``total`` from the
    seed, walked in strides of ``batch``, and the stream's next permutation
    once fewer than ``batch`` ids are left."""
    per = total // batch
    if per == 0:
        raise ValueError("fewer rays than one batch")
    rng = np.random.default_rng(seed)
    out, epoch, perm = [], -1, None
    for i in range(first, first + n):
        e, j = divmod(i, per)
        while epoch < e:
            perm, epoch = rng.permutation(total), epoch + 1
        out.append(perm[j * batch:(j + 1) * batch])
    return out


def jitters(seed: int, batch: int, device, skip: int, n: int) -> list[torch.Tensor]:
    """The trainer's jitter draws ``skip`` .. ``skip + n - 1``: one uniform
    (batch, 1) a step from a generator on the device seeded with the seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    for _ in range(skip):
        torch.rand((batch, 1), generator=g, device=device)
    return [torch.rand((batch, 1), generator=g, device=device) for _ in range(n)]


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    med = float(np.median(list(rn.values())))
    worst = 0.0
    for k in names:
        pn = float(torch.linalg.vector_norm(prog[k].double()))
        worst = max(worst, abs(pn - rn[k]) / max(rn[k], med, 1e-30))
    return worst


def moved_leaves(g1: dict) -> set:
    """Leaves whose reference gradient is over a thousandth of the median
    leaf's: the others move under Adam by rounding alone."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in g1.items()}
    med = float(np.median(list(norms.values())))
    return {k for k, n in norms.items() if n > 1e-3 * med}


def step_gaps(prog: dict, ref: dict) -> dict:
    """Each step's loss (relative, the worst step), the first gradient and
    the change over the steps (by the worst leaf)."""
    mse = max(abs(p - r) / abs(r) for p, r in zip(prog["mse"], ref["mse"]))
    return {"loss_gap": mse, "grad_gap": leaf_gap(prog["g1"], ref["g1"]),
            "change_gap": leaf_gap(prog["change"], ref["change"], moved_leaves(ref["g1"]))}


# ------------------------------------------------------------------- sides

def _program_steps(mses: list, first: int, n: int, m0: dict, m1: dict, p0: dict, pn: dict) -> dict:
    """The program's losses of steps ``first + 1`` .. ``first + n``, its first
    gradient from Adam's first moments before (``m0``) and after (``m1``)
    step ``first + 1`` (m1 = 0.9 m0 + 0.1 g), and its change from ``p0`` to
    ``pn``."""
    return {"mse": mses[first:first + n], "g1": {k: (m1[k] - 0.9 * m0[k]) / 0.1 for k in m1},
            "change": {k: pn[k] - p0[k] for k in pn}}


def train_sides(spec, run: dict, control: bool = False, faults: tuple = ()) -> dict:
    """The program's side and the reference's (and with ``control`` or
    ``faults`` those sides too) of a train cell's run: the bbox filter, the
    events, the planes' crop and resizes, and three sets of steps: the
    first from the seed (``open``), the first after the last event
    (``masked``) and the window's first (``window``)."""
    M.no_tf32()
    cfg, scene, seed, B, E = spec.config, run["scene"], run["seed"], run["batch"], run["E"]
    W = run["warm_end"]
    device = scene.rays.device
    a = cfg["args"]
    geom, snaps, mses = run["geometry"], run["snaps"], run["mses"]
    n = spec.traffic["checked_steps"]

    prog = {"bbox": _bool_of(geom["bbox_ids"], scene.rays.shape[0], device),
            "masks": [ev["occ"] for ev in geom["events"]], "ints": program_ints(geom),
            "resampled": [(r["kind"], r["iteration"], r["after"]) for r in geom["resampled"]]}
    ids = kept_sample(scene, seed, geom["bbox_ids"])
    prog["kept"] = _bool_of(geom["kept_ids"], scene.rays.shape[0], device)[ids]
    zeros = {k: torch.zeros_like(v) for k, v in snaps["open_m1"].items()}
    prog["open"] = _program_steps(mses, 0, n, zeros, snaps["open_m1"], run["weights_flat"],
                                  snaps["open_p3"])
    prog["masked"] = _program_steps(mses, E, n, snaps["adam0"]["m"], snaps["m1"], snaps["p0"],
                                    snaps["p3"])
    prog["window"] = _program_steps(mses, W, n, snaps["adamw"]["m"], snaps["mw1"], snaps["pw"],
                                    snaps["pw3"])

    bbox = bbox_keep(scene, device)
    bbox_ids = bbox.nonzero().squeeze(1).cpu().numpy()
    open_batches = [(torch.as_tensor(bbox_ids[i], device=device), j, it) for it, (i, j) in
                    enumerate(zip(sampler_ids(len(bbox_ids), B, seed, 0, n),
                                  jitters(seed, B, device, 0, n)))]
    birth = min(a["update_AlphaMask_list"])
    kept = np.asarray(geom["kept_ids"])

    def kept_batches(first: int) -> list:
        """Steps ``first + 1`` .. ``first + n`` on the kept rays."""
        return [(torch.as_tensor(kept[i], device=device), j, first + k) for k, (i, j) in
                enumerate(zip(sampler_ids(len(kept), B, seed, first - birth, n),
                              jitters(seed, B, device, first, n)))]

    masked_batches, window_batches = kept_batches(E), kept_batches(W)
    grid0 = M.n_to_reso(cfg["widths"]["plane_res"] ** 3, scene.scene_bbox)
    open_geo = {"aabb": scene.scene_bbox, "step": M.step_size(scene.scene_bbox, grid0, a["step_ratio"]),
                "n_samples": min(a["nSamples"], M.cal_n_samples(grid0, a["step_ratio"]))}

    def side(tf32: bool, fault: str | None) -> dict:
        geo = geometry(cfg, scene, geom["events"], kept, tf32)
        s = {"bbox": bbox, "masks": geo["masks"], "ints": geo["ints"],
             "kept": touches_sample(scene, ids, geo), "geo": geo,
             "resampled": resampled(geo["plan"], geom["events"], geom["resampled"], fault)}
        s["open"] = steps(cfg, scene, run["weights_flat"], None, open_batches,
                          _render_cfg(cfg, scene, open_geo, a["open_sample_cap"]), None,
                          a["L1_weight_initial"], tf32, fault)
        rc = _render_cfg(cfg, scene, geo, geo["cap"])
        s["masked"] = steps(cfg, scene, snaps["p0"], snaps["adam0"], masked_batches, rc,
                            geo["volume"], geo["l1"], tf32, fault)
        s["window"] = steps(cfg, scene, snaps["pw"], snaps["adamw"], window_batches, rc,
                            geo["volume"], geo["l1"], tf32, fault)
        return s

    sides = {"program": prog, "reference": side(False, None)}
    if control:
        sides["control"] = side(True, None)
    for f in faults:
        sides[f] = side(False, f)
    return sides


def compare_train(prog: dict, ref: dict) -> dict:
    out = {"bbox_rays_differ": float((prog["bbox"] != ref["bbox"]).sum())}
    out.update({f"open_{k}": v for k, v in step_gaps(prog["open"], ref["open"]).items()})
    out["mask_voxels_differ"] = float(sum(int(((p > 0) != (r > 0)).sum())
                                          for p, r in zip(prog["masks"], ref["masks"])))
    pi, ri = prog["ints"], ref["ints"]
    out["geometry_differ"] = float(sum(p != r for p, r in zip(pi, ri)) + abs(len(pi) - len(ri)))
    out["planes_differ"] = planes_differ(prog["resampled"], ref["resampled"])
    out["kept_rays_differ"] = float((prog["kept"] != ref["kept"]).sum())
    out.update(step_gaps(prog["masked"], ref["masked"]))
    out.update({f"window_{k}": v for k, v in step_gaps(prog["window"], ref["window"]).items()})
    return out


def _plane_shapes(flat: dict) -> list[tuple[int, int]]:
    return [tuple(flat[n].shape[:2]) for n in ("plane_xy", "plane_yz", "plane_xz")]


def numbers(readings: dict, limits: dict) -> dict:
    """The readings that have a limit, each beside it. The others (checks
    that neither the control nor a fault moves) are not compared."""
    missing = set(limits) - set(readings)
    if missing:
        raise KeyError(f"no reading for limits {sorted(missing)}")
    return {k: {"value": readings[k], "limit": limits[k]} for k in limits}


def train_window_counts(spec, run: dict, geo: dict) -> dict:
    """The samples in the box and the mask and the samples shaded over every
    step of the window: each step's own rays and jitter, the reference's
    geometry, the parameters at the window's start for its first half and
    at its close for the second."""
    cfg, scene, seed, B = spec.config, run["scene"], run["seed"], run["batch"]
    W, n = run["warm_end"], run["steps"]
    device = scene.rays.device
    kept = np.asarray(run["geometry"]["kept_ids"])
    birth = min(cfg["args"]["update_AlphaMask_list"])
    fc = M.FieldCfg.from_config(cfg)
    rc = _render_cfg(cfg, scene, geo, geo["cap"])
    trees = (unflatten(run["snaps"]["pw"]), unflatten(run["snaps"]["pc"]))
    g = torch.Generator(device=device).manual_seed(seed)
    for _ in range(W):
        torch.rand((B, 1), generator=g, device=device)
    valid = shaded = torch.zeros((), dtype=torch.int64, device=device)
    for k, i in enumerate(sampler_ids(len(kept), B, seed, W - birth, n)):
        jitter = torch.rand((B, 1), generator=g, device=device)
        rays = scene.rays[torch.as_tensor(kept[i], device=device)]
        v, sh = M.count_samples(trees[2 * k >= n], fc, rc, rays, W + k, *geo["volume"], jitter)
        valid, shaded = valid + v, shaded + sh
    return {"valid": int(valid), "shaded": int(shaded), "rays": n * B}


def train_numbers(spec, run: dict) -> dict:
    sides = train_sides(spec, run)
    if "trace" in run:
        run["trace"].update(counts=train_window_counts(spec, run, sides["reference"]["geo"]),
                            config=spec.config, planes=_plane_shapes(run["snaps"]["pw"]))
    run["readings"] = compare_train(sides["program"], sides["reference"])
    return numbers(run["readings"], spec.workload["limits"])


# ------------------------------------------------------------------ render

def checked_chunks(seed: int, run: dict, size: int, k: int) -> list[int]:
    """The rendered chunks the reference renders again: ``k`` of them,
    drawn from the seed among those with a ray through a blob's core (within
    1.5 of its widths of the centre), so that each holds the scene's content
    and not only background, where any renderer is right."""
    seen: dict[int, bool] = {}
    cand = []
    for j in range(len(run["outs"])):
        c = j % len(run["chunks"])
        if c not in seen:
            v, i = run["chunks"][c]
            r = run["views"][v][i:i + size]
            seen[c] = bool(near_blobs(r[:, 0:3], r[:, 3:6], 1.5).any())
        if seen[c]:
            cand.append(j)
    rng = np.random.default_rng(seed)
    return sorted(rng.choice(cand, min(k, len(cand)), replace=False).tolist())


def _chunk_rays(run: dict, j: int, size: int) -> torch.Tensor:
    v, i = run["chunks"][j % len(run["chunks"])]
    return run["views"][v][i:i + size]


def _full_render_cfg(cfg: dict, scene, geo: dict) -> M.RenderCfg:
    """The final evaluation's marching: the box's whole diagonal, every group."""
    return _render_cfg(cfg, scene, dict(geo, n_samples=M.grid_n_samples(geo["aabb"], geo["step"])),
                       None)


def render_sides(spec, run: dict, control: bool = False, faults: tuple = ()) -> dict:
    """The program's and the reference's rgb and depth of the checked
    chunks, and the events' readings of both (and the control's and the
    faults' sides)."""
    M.no_tf32()
    cfg, scene, seed = spec.config, run["scene"], run["seed"]
    geom = run["geometry"]
    size = spec.traffic["chunk"]
    picked = checked_chunks(seed, run, size, spec.traffic["checked_chunks"])
    chunk_rays = [_chunk_rays(run, j, size) for j in picked]
    ids = kept_sample(scene, seed, geom["bbox_ids"])
    n = scene.rays.shape[0]
    prog = {"masks": [ev["occ"] for ev in geom["events"]], "ints": program_ints(geom),
            "kept": _bool_of(geom["kept_ids"], n, scene.rays.device)[ids],
            "resampled": [(r["kind"], r["iteration"], r["after"]) for r in geom["resampled"]],
            "rgb": [run["outs"][j][0] for j in picked], "depth": [run["outs"][j][1] for j in picked]}
    kept = np.asarray(geom["kept_ids"])
    it = run["n_iters"] + 1

    def side(tf32: bool, fault: str | None) -> dict:
        geo = geometry(cfg, scene, geom["events"], kept, tf32)
        fc = M.FieldCfg.from_config(cfg, tf32)
        rc = _full_render_cfg(cfg, scene, geo)
        tree = unflatten(run["params"])
        s = {"masks": geo["masks"], "ints": geo["ints"], "kept": touches_sample(scene, ids, geo),
             "resampled": resampled(geo["plan"], geom["events"], geom["resampled"], fault),
             "geo": geo, "rgb": [], "depth": []}
        with torch.no_grad():
            for rays in chunk_rays:
                parts = [M.render(tree, fc, rc, rays[b:b + BLOCK], it, *geo["volume"])
                         for b in range(0, rays.shape[0], BLOCK)]
                rgb = torch.cat([p[0] for p in parts])
                depth = torch.cat([p[1] for p in parts])
                if fault == "half":
                    rgb[rgb.shape[0] // 2:] = 0.0
                if fault == "altered":
                    rgb = rgb + _one_value(rgb, 0.25)
                s["rgb"].append(rgb)
                s["depth"].append(depth)
        return s

    sides = {"program": prog, "reference": side(False, None)}
    if control:
        sides["control"] = side(True, None)
    for f in faults:
        sides[f] = side(False, f)
    return sides


def compare_render(prog: dict, ref: dict) -> dict:
    out = {"mask_voxels_differ": float(sum(int(((p > 0) != (r > 0)).sum())
                                           for p, r in zip(prog["masks"], ref["masks"])))}
    pi, ri = prog["ints"], ref["ints"]
    out["geometry_differ"] = float(sum(p != r for p, r in zip(pi, ri)) + abs(len(pi) - len(ri)))
    out["planes_differ"] = planes_differ(prog["resampled"], ref["resampled"])
    out["kept_rays_differ"] = float((prog["kept"] != ref["kept"]).sum())
    out["rgb_gap"] = max(float((p - r).abs().max()) for p, r in zip(prog["rgb"], ref["rgb"]))
    diff = torch.cat([(p - r).abs().reshape(-1) for p, r in zip(prog["rgb"], ref["rgb"])])
    out["rgb_mean_gap"] = float(diff.double().mean())
    out["depth_gap"] = max(float((p - r).abs().max()) for p, r in zip(prog["depth"], ref["depth"]))
    return out


def render_window_counts(spec, run: dict, geo: dict) -> dict:
    """The samples in the box and the mask and the samples shaded over every
    chunk that the window rendered, from the trained parameters with the
    reference's geometry."""
    size = spec.traffic["chunk"]
    fc = M.FieldCfg.from_config(spec.config)
    rc = _full_render_cfg(spec.config, run["scene"], geo)
    tree = unflatten(run["params"])
    it = run["n_iters"] + 1
    valid = shaded = 0
    rays = 0
    for j in range(len(run["outs"])):
        r = _chunk_rays(run, j, size)
        v, sh = M.count_samples(tree, fc, rc, r, it, *geo["volume"])
        valid, shaded, rays = valid + v, shaded + sh, rays + r.shape[0]
    return {"valid": int(valid), "shaded": int(shaded), "rays": rays}


def render_numbers(spec, run: dict) -> dict:
    sides = render_sides(spec, run)
    if "trace" in run:
        run["trace"].update(counts=render_window_counts(spec, run, sides["reference"]["geo"]),
                            config=spec.config, planes=_plane_shapes(run["params"]))
    run["readings"] = compare_render(sides["program"], sides["reference"])
    return numbers(run["readings"], spec.workload["limits"])
