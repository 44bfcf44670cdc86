// The occupancy test of one point, shared by the standalone lookup K3
// (occupancy_lookup.cu) and the grouped front end K4 (group_compact.cu), so
// that the two cannot drift apart.
//
// `grid_sample_3d(volume, coords) > 0` for a z-major (D, H, W) uint8 volume
// of non-negative values, torch `F.grid_sample` semantics (align_corners=True,
// zero padding, coords[0] -> W, coords[1] -> H, coords[2] -> D): a point is
// occupied iff one of its eight trilinear taps lies inside the volume, holds
// a value > 0 and has a weight wx * wy * wz > 0.
//
// Arithmetic. The float32 operations of the plain version
// (`occupancy_lookup_plain`, ngf_tpu_torch/ops/grid_sample.py), one IEEE
// rounding each and never fused into an FMA (the __f*_rn intrinsics):
// normalize_coord with the grid's box, (c + 1) * 0.5 * (size - 1), a clamp to
// [-2, size + 1] that sends NaN to -2 (both leave every tap of the axis
// outside the volume, as without the clamp), floor and fraction, and the
// weight products in grid_sample_3d's order. So every caller agrees with the
// plain version byte for byte.
//
// Taps. All in-range and weight predicates are computed first; then each
// needed tap is one independent byte load (predicated, no chain of dependent
// branches), ORed together. Indices are 32-bit: callers keep D * H * W
// below 2^31.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace occ {

struct Axis {
    int c0;   // floor of the unnormalised coordinate
    float f;  // its fraction
};

__device__ __forceinline__ Axis axis(float c, int size) {
    // (c + 1) * 0.5 * (size - 1): align_corners=True.
    float u = __fmul_rn(__fmul_rn(__fadd_rn(c, 1.0f), 0.5f), (float)(size - 1));
    if (!(u >= -2.0f)) u = -2.0f;  // NaN too
    const float hi = (float)size + 1.0f;
    if (u > hi) u = hi;
    const float u0 = floorf(u);
    return Axis{(int)u0, __fsub_rn(u, u0)};
}

// A box's normalisation, normalize_coord's operands: lo = aabb[0] and
// inv = 2.0 / (aabb[1] - aabb[0]).
struct Box {
    float lo[3];
    float inv[3];
};

__device__ __forceinline__ Box load_box(const float* __restrict__ aabb) {
    Box b;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        b.lo[k] = aabb[k];
        b.inv[k] = __fdiv_rn(2.0f, __fsub_rn(aabb[3 + k], aabb[k]));
    }
    return b;
}

// normalize_coord of one component: (v - lo) * inv - 1.0.
__device__ __forceinline__ float normalize(float v, float lo, float inv) {
    return __fsub_rn(__fmul_rn(__fsub_rn(v, lo), inv), 1.0f);
}

// Is the point at coordinates (cx, cy, cz) in [-1, 1] in occupied space?
__device__ __forceinline__ bool occupied(float cx, float cy, float cz,
                                         const uint8_t* __restrict__ vol, int D, int H, int W) {
    const Axis x = axis(cx, W), y = axis(cy, H), z = axis(cz, D);
    const float wx[2] = {__fsub_rn(1.0f, x.f), x.f};
    const float wy[2] = {__fsub_rn(1.0f, y.f), y.f};
    const float wz[2] = {__fsub_rn(1.0f, z.f), z.f};
    const bool xin[2] = {x.c0 >= 0 && x.c0 < W, x.c0 + 1 >= 0 && x.c0 + 1 < W};
    const bool yin[2] = {y.c0 >= 0 && y.c0 < H, y.c0 + 1 >= 0 && y.c0 + 1 < H};
    const bool zin[2] = {z.c0 >= 0 && z.c0 < D, z.c0 + 1 >= 0 && z.c0 + 1 < D};
    unsigned hit = 0;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
            const float wxy0 = __fmul_rn(wx[0], wy[dy]), wxy1 = __fmul_rn(wx[1], wy[dy]);
            const int row = ((z.c0 + dz) * H + (y.c0 + dy)) * W + x.c0;
            const bool zy = zin[dz] && yin[dy];
            if (zy && xin[0] && __fmul_rn(wxy0, wz[dz]) > 0.0f) hit |= vol[row];
            if (zy && xin[1] && __fmul_rn(wxy1, wz[dz]) > 0.0f) hit |= vol[row + 1];
        }
    }
    return hit != 0;
}

// The occupancy of a world point p, normalised with the grid's box.
__device__ __forceinline__ bool occupied_world(const float p[3], const Box& box,
                                               const uint8_t* __restrict__ vol, int D, int H,
                                               int W) {
    return occupied(normalize(p[0], box.lo[0], box.inv[0]), normalize(p[1], box.lo[1], box.inv[1]),
                    normalize(p[2], box.lo[2], box.inv[2]), vol, D, H, W);
}

}  // namespace occ
