// The clipped 2x2 bilinear stencil shared by the gather kernel and its
// backward (bilinear_gather.cu, bilinear_gather_backward.cu), and the
// derivatives of its weights for the coordinate gradient.
//
// `grid_sample_2d` semantics (ngf_tpu/ops/grid_sample.py:216-253): torch
// `F.grid_sample` with align_corners=True and zero padding. coords[n, 0]
// indexes the W axis and coords[n, 1] the H axis, both in [-1, 1]. Per axis
// the 2-texel stencil starts at clip(floor(c), 0, size - 2); a stencil slot's
// weight is the bilinear weight its texel has in the *unclipped* stencil, or 0
// if it is not part of it (`_axis_patch_weights`, grid_sample.py:38-57). That
// is zero padding without any out-of-bounds access. A point's four taps are
// (y0, x0), (y0, x1), (y1, x0), (y1, x1) with weights wy * wx.

#pragma once

// One axis of the clipped stencil. c is the raw coordinate in [-1, 1];
// returns the stencil start and the two slot weights. Values beyond one texel
// outside the plane are clamped first: they get weight 0 either way, and the
// clamp keeps the float-to-int conversion in range.
__device__ __forceinline__ int axis_stencil(float c, int size, float* w0, float* w1) {
    float x = (c + 1.0f) * 0.5f * (float)(size - 1);
    x = fminf(fmaxf(x, -2.0f), (float)size + 1.0f);
    float xf = floorf(x);
    float frac = x - xf;
    int c0 = (int)xf;
    int start = min(max(c0, 0), size - 2);
    *w0 = (start == c0 ? 1.0f - frac : 0.0f) + (start == c0 + 1 ? frac : 0.0f);
    *w1 = (start + 1 == c0 ? 1.0f - frac : 0.0f) + (start + 1 == c0 + 1 ? frac : 0.0f);
    return start;
}

// `axis_stencil` with the derivatives of the two slot weights with respect
// to the clamped unnormalised coordinate: w0 and w1 are piecewise linear in
// it, so dw = +1 where the slot's texel is the stencil's upper corner, -1
// where it is the lower one, 0 where it is neither (`_axis_weight_grads`,
// ngf_tpu/ops/grid_sample.py:354-363, which autodiff of `_axis_patch_weights`
// equals). Beyond the clamp every weight and derivative is 0.
__device__ __forceinline__ int axis_stencil_grad(float c, int size, float* w0, float* w1,
                                                 float* dw0, float* dw1) {
    float x = (c + 1.0f) * 0.5f * (float)(size - 1);
    x = fminf(fmaxf(x, -2.0f), (float)size + 1.0f);
    float xf = floorf(x);
    float frac = x - xf;
    int c0 = (int)xf;
    int start = min(max(c0, 0), size - 2);
    *w0 = (start == c0 ? 1.0f - frac : 0.0f) + (start == c0 + 1 ? frac : 0.0f);
    *w1 = (start + 1 == c0 ? 1.0f - frac : 0.0f) + (start + 1 == c0 + 1 ? frac : 0.0f);
    *dw0 = (start == c0 + 1 ? 1.0f : 0.0f) - (start == c0 ? 1.0f : 0.0f);
    *dw1 = (start + 1 == c0 + 1 ? 1.0f : 0.0f) - (start + 1 == c0 ? 1.0f : 0.0f);
    return start;
}
