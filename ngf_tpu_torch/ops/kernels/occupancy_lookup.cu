// Occupancy lookup (K3) for Hopper (sm_90a): is a point inside occupied
// space of the binary alpha mask?
//
// Replaces the trilinear alpha-mask lookup of the JAX package, a hand-written
// XLA op: `_sample_alpha_volume` (ngf_tpu/render/volume.py:42-54), which runs
// `grid_sample_3d_blocks` on the bf16 parity table of `make_block_table_3d`
// (ngf_tpu/ops/grid_sample.py:507-556) or `grid_sample_3d` (:559-613). Every
// consumer tests the trilinear value `> 0` (render/volume.py:243,249,452,534,
// train/occupancy.py:85-86,100-101), so the kernel returns that test and
// needs no table: a point is occupied iff one of its eight taps lies inside
// the volume, holds a value > 0 and has a weight wx * wy * wz > 0.
//
// Arithmetic. The same float32 operations as the plain version
// (`occupancy_lookup_plain`, ngf_tpu_torch/ops/grid_sample.py), one IEEE
// rounding each and never fused into an FMA (the __f*_rn intrinsics):
// normalize_coord with the grid's aabb, (c + 1) * 0.5 * (size - 1), a clamp
// to [-2, size + 1] that sends NaN to -2 (both leave every tap of the axis
// outside the volume, as without the clamp), floor and fraction, and the
// weight products in grid_sample_3d's order. So the kernel and the plain
// version agree byte for byte.
//
// Layout. points is an (A, B, 3) float32 view with any strides, such as the
// per-group query points pts[:, G/4::G/2] or a flat (M, 3) array (A = 1); it
// is read as it lies. volume is (D, H, W) uint8, contiguous, z-major (x -> W).
// out is (A * B) bytes, 1 = occupied.
//
// Bound on an H100 SXM: memory. Each point reads 12 bytes and writes one;
// the volume (2 MiB at 128^3, 16 MiB at 256^3) is read from the 50 MB L2
// after its first touch. For the 909,312 lookups of a masked train step that
// is ~11.8 MB plus the volume, ~4 us at 3.35 TB/s; the ~60 operations a point
// take under 1 us at 67 TFLOP/s. Design: one thread per point, a grid-stride
// loop, the taps read in z, y, x order with an exit at the first hit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

__global__ void __launch_bounds__(THREADS) occupancy_lookup_kernel(
    const float* __restrict__ pts, long long A, long long B, long long sa, long long sb,
    long long sc, const float* __restrict__ aabb, const uint8_t* __restrict__ vol, int D,
    int H, int W, uint8_t* __restrict__ out) {
    const long long M = A * B;
    float lo[3] = {0.f, 0.f, 0.f}, inv[3] = {1.f, 1.f, 1.f};
    if (aabb != nullptr) {
        for (int k = 0; k < 3; ++k) {
            lo[k] = aabb[k];
            // inv_size = 2.0 / (aabb[1] - aabb[0])
            inv[k] = __fdiv_rn(2.0f, __fsub_rn(aabb[3 + k], aabb[k]));
        }
    }
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < M;
         i += (long long)gridDim.x * THREADS) {
        const long long a = i / B;
        const float* p = pts + a * sa + (i - a * B) * sb;
        float c[3];
        for (int k = 0; k < 3; ++k) {
            const float v = p[k * sc];
            // (xyz - aabb[0]) * inv_size - 1.0
            c[k] = aabb != nullptr ? __fsub_rn(__fmul_rn(__fsub_rn(v, lo[k]), inv[k]), 1.0f) : v;
        }
        const Axis x = axis(c[0], W), y = axis(c[1], H), z = axis(c[2], D);
        uint8_t hit = 0;
        for (int dz = 0; dz < 2 && !hit; ++dz) {
            const int zi = z.c0 + dz;
            if (zi < 0 || zi >= D) continue;
            const float wz = dz ? z.f : __fsub_rn(1.0f, z.f);
            for (int dy = 0; dy < 2 && !hit; ++dy) {
                const int yi = y.c0 + dy;
                if (yi < 0 || yi >= H) continue;
                const float wy = dy ? y.f : __fsub_rn(1.0f, y.f);
                for (int dx = 0; dx < 2 && !hit; ++dx) {
                    const int xi = x.c0 + dx;
                    if (xi < 0 || xi >= W) continue;
                    const float wx = dx ? x.f : __fsub_rn(1.0f, x.f);
                    if (__fmul_rn(__fmul_rn(wx, wy), wz) > 0.0f &&
                        vol[((long long)zi * H + yi) * W + xi] != 0) {
                        hit = 1;
                    }
                }
            }
        }
        out[i] = hit;
    }
}

}  // namespace

extern "C" {

// points: (A, B, 3) float32 with element strides sa, sb, sc; aabb: (2, 3)
// float32 contiguous, or null when the points are coordinates in [-1, 1];
// volume: (D, H, W) uint8 contiguous; out: A * B bytes. Launches on `stream`
// and returns the cudaError_t of the launch (0 on success). A * B must be > 0.
int ngf_occupancy_lookup(const float* pts, long long A, long long B, long long sa, long long sb,
                         long long sc, const float* aabb, const uint8_t* vol, int D, int H, int W,
                         uint8_t* out, void* stream) {
    const long long M = A * B;
    long long blocks = (M + THREADS - 1) / THREADS;
    if (blocks > 132LL * 64) blocks = 132LL * 64;
    occupancy_lookup_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        pts, A, B, sa, sb, sc, aabb, vol, D, H, W, out);
    return (int)cudaGetLastError();
}

const char* ngf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
