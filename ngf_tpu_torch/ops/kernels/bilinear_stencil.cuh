// The clipped 2x2 bilinear stencil shared by the gather kernel and its
// backward (bilinear_gather.cu, bilinear_gather_backward.cu).
//
// `grid_sample_2d` semantics (ngf_tpu/ops/grid_sample.py:216-253): torch
// `F.grid_sample` with align_corners=True and zero padding. coords[n, 0]
// indexes the W axis and coords[n, 1] the H axis, both in [-1, 1]. Per axis
// the 2-texel stencil starts at clip(floor(c), 0, size - 2); a stencil slot's
// weight is the bilinear weight its texel has in the *unclipped* stencil, or 0
// if it is not part of it (`_axis_patch_weights`, grid_sample.py:38-57). That
// is zero padding without any out-of-bounds access.

#pragma once

// Points a block owns; one thread computes one point's taps.
constexpr int STENCIL_POINTS = 64;

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

// The four taps of the points [first, first + npts) into shared memory:
// element offsets (texel * texel_stride) and weights, in the order
// (y0, x0), (y0, x1), (y1, x0), (y1, x1). Threads below npts each do one
// point; the caller synchronises before reading.
__device__ __forceinline__ void stencil_taps(
    const float* __restrict__ coords, long long coord_stride_n, long long coord_stride_k,
    int H, int W, long long texel_stride, long long first, int npts,
    long long (*s_off)[STENCIL_POINTS], float (*s_w)[STENCIL_POINTS]) {
    if (threadIdx.x < npts) {
        const float* cp = coords + (first + threadIdx.x) * coord_stride_n;
        float wx0, wx1, wy0, wy1;
        int xs = axis_stencil(cp[0], W, &wx0, &wx1);
        int ys = axis_stencil(cp[coord_stride_k], H, &wy0, &wy1);
        long long t00 = ((long long)ys * W + xs) * texel_stride;
        long long down = (long long)W * texel_stride;
        s_off[0][threadIdx.x] = t00;
        s_off[1][threadIdx.x] = t00 + texel_stride;
        s_off[2][threadIdx.x] = t00 + down;
        s_off[3][threadIdx.x] = t00 + down + texel_stride;
        s_w[0][threadIdx.x] = wy0 * wx0;
        s_w[1][threadIdx.x] = wy0 * wx1;
        s_w[2][threadIdx.x] = wy1 * wx0;
        s_w[3][threadIdx.x] = wy1 * wx1;
    }
}
