"""Product operations of the NeuTex model (`reference/neutex.py`): the
multiply-adds of each of its four networks' layers for one point, from the
configuration's widths, and the operations (2 a multiply-add) of a number of
samples decoded and template points mapped. The geometry, gauge and texture
networks run at every sample, the inverse network at every template point
and, with an inverse-mapping weight, at every sample too. Training counts
the backward as twice the forward."""

from __future__ import annotations


def layer_dims(cfg: dict) -> dict[str, list[tuple[int, int]]]:
    """(in, out) of every layer, by network."""
    w = cfg["widths"]
    uv = 2 if cfg["args"]["primitive_type"] == "square" else 3
    chain = lambda dims: list(zip(dims[:-1], dims[1:]))  # noqa: E731
    tw = w["tex_width"]
    return {
        "geometry": chain([3 + 6 * w["geo_freqs"]] + [w["geo_hidden"]] * (w["geo_layers"] + 1) + [1]),
        "gauge": chain([3 + 60, w["gauge_mid"], w["gauge_hidden"]]
                       + [w["gauge_hidden"]] * w["gauge_layers"] + [uv]),
        "texture": chain([uv + 2 * uv * w["tex_freqs"]] + [tw] * (w["tex_layers1"] + 1))
        + [(tw, 3)] + chain([tw + 3 + 6 * w["view_freqs"]] + [tw] * (w["tex_layers2"] + 1) + [3]),
        "inverse": chain([uv, w["inverse_mid"], w["inverse_hidden"]]
                         + [w["inverse_hidden"]] * w["inverse_layers"] + [3]),
    }


def macs(cfg: dict) -> dict[str, int]:
    """Multiply-adds of one point through each network."""
    return {k: sum(a * b for a, b in dims) for k, dims in layer_dims(cfg).items()}


def flops(cfg: dict, slots: int, template: int, train: bool = True) -> float:
    """The products' operations of ``slots`` samples and ``template``
    template points."""
    m = macs(cfg)
    per_sample = m["geometry"] + m["gauge"] + m["texture"]
    if cfg["args"]["loss_inverse_mapping_weight"] > 0:
        per_sample += m["inverse"]
    fwd = 2.0 * (slots * per_sample + template * m["inverse"])
    return 3.0 * fwd if train else fwd
