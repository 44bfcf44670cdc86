"""Config/flag system: the port's own copy of `ngf_tpu/config.py`.

InfoInv/TriPlane use configargparse (CLI flags + ``--config`` file of
``key = value`` lines, CLI overriding file — `InfoInv/opt.py:3-123`,
`TriPlane/opt.py:115`). This module implements the same contract with stdlib
argparse, so ``configs/*.txt`` parse exactly as they do for the JAX package.
The knobs of the JAX package's TPU machinery are accepted and have no effect
in the port. The port adds ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch versions of the kernels).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any


def parse_config_file(path: str) -> dict[str, Any]:
    """Parse a ``key = value`` config file with # comments and [..] lists."""
    out: dict[str, Any] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = (s.strip() for s in line.split("=", 1))
            out[key] = _parse_value(val)
    return out


def _parse_value(val: str) -> Any:
    if val.startswith("[") and val.endswith("]"):
        inner = val[1:-1].strip()
        return [_parse_value(v.strip()) for v in inner.split(",")] if inner else []
    for cast in (int, float):
        try:
            return cast(val)
        except ValueError:
            pass
    if val.lower() in ("true", "false"):
        return val.lower() == "true"
    return val


@dataclasses.dataclass
class TrainArgs:
    """All knobs of `InfoInv/opt.py` + `TriPlane/opt.py` plus TPU-native ones."""

    config: str | None = None
    expname: str = "exp"
    basedir: str = "./log"
    add_timestamp: int = 0
    datadir: str = "./data/llff/fern"
    progress_refresh_rate: int = 10

    with_depth: bool = False
    downsample_train: float = 1.0
    downsample_test: float = 1.0

    model_name: str = "TriPlane"
    subsystem: str = "infoinv"  # 'infoinv' | 'triplane' (reference: repo dir)
    batch_size: int = 4096
    n_iters: int = 30000
    dataset_name: str = "blender"

    lr_init: float = 0.02
    lr_basis: float = 1e-3
    lr_decay_iters: int = -1
    lr_decay_target_ratio: float = 0.1
    lr_upsample_reset: int = 1

    # The reference accepts these but hardcodes 8e-5 -> 4e-5 regardless
    # (`InfoInv/main.py:259,328`; opt.py defaults 0.0 are never read). Here
    # they are WIRED, with defaults equal to the reference's hardcoded
    # schedule so default behavior matches the reference exactly while
    # explicit values actually take effect.
    L1_weight_initial: float = 8e-5
    L1_weight_rest: float = 4e-5
    Ortho_weight: float = 0.0
    TV_weight_density: float = 0.0
    TV_weight_app: float = 0.0

    rm_weight_mask_thre: float = 1e-4
    alpha_mask_thre: float = 1e-4
    # Occupancy-alpha length scale. 0 = reference semantics: alpha for the
    # mask threshold is 1-exp(-sigma * CURRENT step) (`TriPlane/models/
    # FieldBase.py:158,177` passes self.stepSize), which makes the fixed
    # 1e-4 threshold ~3.4x harsher in sigma after the lego schedule's
    # shrink+upsample — measured on the bundled scene to cull live border
    # cells at the SECOND mask event and permanently collapse training
    # (round-5 E1/E2/E6 isolation, NOTES.md; 52.6 -> 39 train PSNR).
    # > 0 = evaluate mask alpha at this FIXED length instead, making the
    # cull scale-invariant across upsample events (set it to the
    # pre-upsample step, e.g. 0.0059 for the lego schedule).
    alpha_mask_len: float = 0.0
    distance_scale: float = 25.0
    density_shift: float = -10.0

    ckpt: str | None = None
    render_only: int = 0
    render_test: int = 0
    render_train: int = 0
    render_path: int = 0
    export_mesh: int = 0

    lindisp: bool = False
    perturb: float = 1.0
    accumulate_decay: float = 0.998
    ndc_ray: int = 0
    nSamples: int = 1_000_000
    step_ratio: float = 0.5

    white_bkgd: bool = False
    N_voxel_init: int = 100 ** 3
    N_voxel_final: int = 300 ** 3
    upsamp_list: list[int] = dataclasses.field(default_factory=list)
    update_AlphaMask_list: list[int] = dataclasses.field(default_factory=list)

    idx_view: int = 0
    N_vis: int = 5
    vis_every: int = 10000
    transform_type: str = "continuous"
    infoinv: bool = False
    gauge_start: int = 0

    # TPU-native additions (no reference counterpart):
    seed: int = 20211202
    sample_cap: int = 0  # per-ray sample capacity; 0 = dense, -1 = auto
    # (-1: dense until the first occupancy grid, then the measured
    # 99.9th-percentile occupied-samples count — no silent truncation)
    rgb_cap: int = 0  # top-K shading capacity; 0 = all (dense, reference
    # semantics), -1 = sample_cap/4 (aggressive, measurably lossy in
    # training — NOTES.md), -2 = AUTO: the measured ~p99.9 per-ray count of
    # above-threshold shaded groups + 25% margin, re-picked at event
    # rebuilds (exactly reproduces dense shading while the margin holds —
    # sub-threshold samples are rgb-masked to zero in both codebases)
    # Pre-mask (open) stage capacity when sample_cap == -1: before the first
    # occupancy grid exists there are no statistics to auto-tune from, and
    # dense S=886 x 4096-ray scan blocks exceed HBM on a single v5e chip.
    # 0 = dense; a value ~ the bbox-crossing span (e.g. 512 for lego-scale
    # cubic scenes) drops almost nothing (out-of-bbox samples only).
    open_sample_cap: int = 0
    # with sample_cap=-1: manual post-mask capacity overriding the measured
    # p99.9 auto-cap (0 = use the measurement)
    masked_sample_cap: int = 0
    mask_stride: int = 1  # occupancy lookup every K-th sample (see RenderConfig)
    group_size: int = 8  # sample-compaction group length (0 = round-1 path)
    run_len: int = 4  # samples served per tiled-gather descriptor
    # tile_q=0 disables tiled gathers (measured 2026-08-16: the one-hot
    # selection einsums lower to padded batched GEMMs, 468 ms/step vs the
    # blocks gather's 102 ms; see NOTES.md round-2 log before re-enabling).
    tile_q: int = 0
    # pair_gather=1: plane gathers via overlapping 4x4 stride-2 duo tables,
    # one descriptor per TWO consecutive samples (grouped path, even
    # group_size; see ops/grid_sample.py:make_duo_table).
    pair_gather: int = 0
    # fused_fetch=1: ONE 96-channel gather per sample serves density AND
    # appearance. A regression vs top-K-shaded separate fetches (round 2:
    # 130 vs 88 ms/step), but it HALVES gather+scatter descriptors vs
    # dense-shaded separate fetches — the shipped TPU configs enable it
    # together with dense shading (rgb_cap 0/-2); see NOTES.md round 3.
    fused_fetch: int = 0
    # duo_bwd=1: blocks-forward / duo-backward plane sampling — halves the
    # backward plane-gradient scatter descriptors (the training-step wall)
    # while keeping the measured-fastest forward. Grouped path, even
    # group_size (see ops/grid_sample.py:grid_sample_2d_blocks_duobwd).
    duo_bwd: int = 0
    # Mesh shape "DATAxSAMPLE" (e.g. "4x2") over the run's ranks: rays
    # split over the data axis, samples-per-ray over the sample axis (the
    # sequence-parallel analog, SURVEY.md §5). "" = a 1D data mesh when
    # there are several ranks. With a sample axis of more than one rank the
    # trainer uses the dense sample-parallel renderer
    # (parallel/sample_parallel.py): occupancy culling and fixed-capacity
    # compaction are per-chip concepts and are NOT applied there — the mode
    # exists to scale samples-per-ray beyond one chip's memory/appetite.
    mesh_shape: str = ""
    plane_res: int = 256  # reference hard-codes 256 (Field.py:14/17)
    gauge_res: int = 256
    compute_dtype: str = "float32"  # reference-parity default; bfloat16 validated
    # end-to-end on TPU at +0.23 dB vs f32 (NOTES.md round-2) and ~1.2x faster
    microbatch: int = 1  # gradient accumulation chunks per step (memory knob)
    steps_per_call: int = 64  # train steps fused into one device call (scan)
    alpha_grid_res: int = 256  # occupancy grid resolution (ref: main.py:324)
    # prewarm_events=1: compile the mask-event machinery and the predicted
    # masked-stage train step in a background thread DURING the open stage,
    # so the first event's multi-minute remote-XLA compiles are already in
    # the service cache when the event fires (train/loop.py:_prewarm_worker).
    # Best-effort; 0 disables.
    prewarm_events: int = 1
    filter_rays: int = 1  # bbox pre-filter of training rays (ref: main.py:252)
    save_every: int = 10000
    eval_chunk: int = 4096
    compute_extra_metrics: int = 1
    # The port's own: where it runs. 'cuda' raises if there is no card.
    device: str = "cuda"

    def __post_init__(self):
        """Reject knobs that are parsed-but-dead in the reference when set
        to non-default values, instead of silently ignoring them (the same
        loud-failure policy as the Ortho_weight guard in train/loop.py).

        Each listed knob is accepted by `InfoInv/opt.py`/`TriPlane/opt.py`
        but never read by any reference code path (grep-verified; `lindisp`/
        `perturb` only reach the unused `ray_marcher`, `lr_upsample_reset`'s
        else-branch is commented out at `TriPlane/main.py:351-355`)."""
        dead = [
            ("with_depth", self.with_depth, False),
            ("lindisp", self.lindisp, False),
            ("white_bkgd", self.white_bkgd, False),
            ("perturb", self.perturb, 1.0),
            ("accumulate_decay", self.accumulate_decay, 0.998),
            ("idx_view", self.idx_view, 0),
            ("transform_type", self.transform_type, "continuous"),
            ("lr_upsample_reset", self.lr_upsample_reset, 1),
        ]
        for name, val, default in dead:
            if val != default:
                raise NotImplementedError(
                    f"--{name}={val!r}: this knob is parsed but dead code in "
                    "the reference (it would change nothing there either); "
                    "refusing to silently ignore a non-default value."
                )
        if self.model_name != "TriPlane":
            raise NotImplementedError(
                f"--model_name={self.model_name!r}: the reference ships only "
                "the TriPlane field (`InfoInv/models/Field.py:10`)."
            )
        if self.ndc_ray and self.dataset_name != "llff":
            raise NotImplementedError(
                "--ndc_ray=1 with a non-LLFF dataset: the reference applies "
                "NDC only inside the LLFF loader (`dataLoader/llff.py:218`)."
            )


_BOOL_FLAGS = {"with_depth", "lindisp", "white_bkgd", "infoinv"}


def config_parser(cmd: list[str] | None = None) -> TrainArgs:
    """Parse CLI (+ optional --config file) into TrainArgs."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", type=str, default=None)
    pre_args, _ = pre.parse_known_args(cmd)

    defaults = dataclasses.asdict(TrainArgs())
    if pre_args.config:
        file_vals = parse_config_file(pre_args.config)
        unknown = set(file_vals) - set(defaults)
        if unknown:
            raise ValueError(f"unknown config keys in {pre_args.config}: {sorted(unknown)}")
        defaults.update(file_vals)
    defaults["config"] = pre_args.config

    parser = argparse.ArgumentParser()
    for f in dataclasses.fields(TrainArgs):
        name = f.name
        if name == "config":
            parser.add_argument("--config", type=str, default=defaults["config"])
            continue
        default = defaults[name]
        if name in _BOOL_FLAGS:
            if default:
                parser.add_argument(f"--{name}", action="store_true", default=True)
            else:
                parser.add_argument(f"--{name}", action="store_true", default=False)
        elif isinstance(default, list) or f.type.startswith("list"):
            parser.add_argument(f"--{name}", type=int, action="append", default=default)
        elif isinstance(default, bool):
            parser.add_argument(f"--{name}", type=int, default=int(default))
        elif isinstance(default, int):
            parser.add_argument(f"--{name}", type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(f"--{name}", type=float, default=default)
        else:
            parser.add_argument(f"--{name}", type=str, default=default)
    ns = parser.parse_args(cmd)
    return TrainArgs(**vars(ns))
