// The grouped render path's front end (K4, `group_sample_compact`) for
// Hopper (sm_90a): per ray, the fixed-step samples, their in-box and
// occupancy tests, and the first `capg` groups of G consecutive samples that
// hold a valid sample, in marching order, with their depths, validity and
// normalised coordinates. One launch per grouped render.
//
// Replaces a hand-written XLA op of the JAX package's grouped renderer
// (ngf_tpu/render/volume.py:218-264): `stratified_sample`
// (ngf_tpu/ops/rays.py:59-94), the last-sample mask and the edge padding, the
// occupancy queries (`_sample_alpha_volume > 0`, two a group at its quarter
// and three-quarter samples for an even G >= 4, else one at its centre),
// `group_compact_indices` and `gather_groups` of the (z_vals, valid) payload
// (ngf_tpu/ops/compaction.py:26-66), and `normalize_coord` of the kept
// samples. Outputs, exactly as the plain composition
// (`group_sample_compact_plain`, ngf_tpu_torch/ops/compaction.py) gives them:
//   z_c   (n, capg*G) f32     the slot's group's depths (group 0's in a pad
//                             slot, as JAX's idx = 0 gathers them);
//   vmask (n, capg*G) f32     valid as 0/1 in a held slot, 0 in a pad slot;
//   xyz   (n, capg*G, 3) f32  normalize_coord(o + d * z_c, aabb);
//   idx   (n, capg) int32     the group of each slot, 0 in a pad slot, and
//   got   (n, capg) bool      the slot holds a group: written only when asked.
// A sample k of a ray: z = t_min + step * (k + u) with t_min as
// `ray_aabb_tmin` gives it (exactly-zero direction components as 1e-6, the
// NaN-propagating minimum, maximum and clamp to [near, far]) and u the ray's
// jitter (0 without); a pad sample k >= S takes sample S - 1's depth. Valid
// iff k < S - 1, the point o + d * z lies in the box and, with a volume, its
// query point is occupied. Every float operation is one IEEE rounding
// (__f*_rn, no FMA), so the outputs equal the plain composition byte for byte.
//
// Design: one warp per ray. The ray's six floats, its jitter and t_min sit in
// registers. The lanes walk the ray's ng groups 32 at a time: each lane
// computes its group's G points and validity (the occupancy test through
// occ::occupied, occupancy.cuh, shared with K3; a query is skipped when no
// sample it serves lies in the box), a ballot and a popcount of the lower
// lanes give each valid group its slot. For G = 8 the held groups of a pass
// are staged in shared memory and leave as contiguous 16-byte stores of the
// whole warp, rather than each lane storing its own group's 160 bytes, 32
// bytes apart from the next lane's (measured slower on every shape of
// chip_smoke.py); any other G takes a generic kernel whose lanes store their
// groups. The warp stops once
// capg slots are full, so an open step never looks at the groups beyond its
// cap. Then the warp fills the pad slots. The volume (2 MiB at 128^3) stays
// in the L2.
//
// Bound on an H100 SXM: memory. The outputs, 20 bytes a slot sample, are
// written once; the rays and jitter read once, the volume from the L2. A
// masked step at cap 224: 4096 * 224 * 20 B = 18.4 MB, ~5.5 us; an open
// step at capg 64, 41.9 MB, ~12.5 us; an evaluation chunk with all 111
// groups, 72.7 MB, ~21.7 us. Forward only: nothing here depends on a
// parameter.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "occupancy.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

struct Args {
    const float* rays;
    long long ray_stride;
    const float* jitter;  // null: no jitter
    long long jitter_stride;
    const float* aabb;
    float near, far, step;
    int n, S, G, ng, capg;
    const uint8_t* vol;  // null: no occupancy test
    int D, H, W;
    const float* vol_aabb;
    int* idx;  // null: idx and got are not written
    uint8_t* got;
    float* z_c;
    float* vmask;
    float* xyz;
};

// torch.minimum / amax / clamp on float32: a NaN operand gives NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
    return (a != a) ? a : (b != b) ? b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a) ? a : (b != b) ? b : fmaxf(a, b);
}

struct Ray {
    float o[3], d[3];
    float t_min, u;
    occ::Box box;
    float lo[3], hi[3];
};

__device__ __forceinline__ Ray load_ray(const Args& a, int ray) {
    Ray r;
    const float* p = a.rays + (long long)ray * a.ray_stride;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        r.o[k] = p[k];
        r.d[k] = p[3 + k];
        r.lo[k] = a.aabb[k];
        r.hi[k] = a.aabb[3 + k];
    }
    r.box = occ::load_box(a.aabb);
    // ray_aabb_tmin (ngf_tpu_torch/ops/rays.py).
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float vec = r.d[k] == 0.0f ? 1e-6f : r.d[k];
        const float rate_a = __fdiv_rn(__fsub_rn(r.hi[k], r.o[k]), vec);
        const float rate_b = __fdiv_rn(__fsub_rn(r.lo[k], r.o[k]), vec);
        const float m = nan_min(rate_a, rate_b);
        t = k == 0 ? m : nan_max(t, m);
    }
    if (t == t) t = fminf(fmaxf(t, a.near), a.far);
    r.t_min = t;
    r.u = a.jitter != nullptr ? a.jitter[(long long)ray * a.jitter_stride] : 0.0f;
    return r;
}

// Depth of padded sample k: t_min + step * (k + u), k capped at S - 1.
__device__ __forceinline__ float depth(const Ray& r, const Args& a, int k) {
    const float rng = __fadd_rn((float)min(k, a.S - 1), r.u);
    return __fadd_rn(r.t_min, __fmul_rn(a.step, rng));
}

__device__ __forceinline__ void point(const Ray& r, float z, float p[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = __fadd_rn(r.o[k], __fmul_rn(r.d[k], z));
}

__device__ __forceinline__ bool in_box(const Ray& r, const float p[3]) {
    return p[0] >= r.lo[0] && p[0] <= r.hi[0] && p[1] >= r.lo[1] && p[1] <= r.hi[1]
           && p[2] >= r.lo[2] && p[2] <= r.hi[2];
}

__device__ __forceinline__ bool query(const Ray& r, const Args& a, const occ::Box& vbox, int k) {
    float p[3];
    point(r, depth(r, a, k), p);
    return occ::occupied_world(p, vbox, a.vol, a.D, a.H, a.W);
}

// Bit j set: sample j of group g is valid.
template <int GT>
__device__ __forceinline__ uint32_t group_bits(const Ray& r, const Args& a, const occ::Box& vbox,
                                               int g) {
    const int G = GT > 0 ? GT : a.G;
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < (GT > 0 ? GT : 32); ++j) {
        if (GT == 0 && j >= G) break;
        const int k = g * G + j;
        float p[3];
        point(r, depth(r, a, k), p);
        if (k < a.S - 1 && in_box(r, p)) bits |= 1u << j;
    }
    if (a.vol != nullptr && bits != 0) {
        if (G >= 4 && G % 2 == 0) {
            // Two queries, each serving G/2 samples.
            const int half = G / 2;
            const uint32_t lower = (1u << half) - 1u;
            if ((bits & lower) && !query(r, a, vbox, g * G + G / 4)) bits &= ~lower;
            if ((bits >> half) && !query(r, a, vbox, g * G + G / 4 + half)) bits &= lower;
        } else if (!query(r, a, vbox, g * G + G / 2)) {
            bits = 0;
        }
    }
    return bits;
}

// Group g's depths, validity (bits) and coordinates into one slot, any G.
__device__ __forceinline__ void write_group(const Ray& r, const Args& a, int g, uint32_t bits,
                                            float* zo, float* mo, float* xo) {
    for (int j = 0; j < a.G; ++j) {
        const float z = depth(r, a, g * a.G + j);
        float p[3];
        point(r, z, p);
        zo[j] = z;
        mo[j] = (bits >> j) & 1u ? 1.0f : 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) xo[3 * j + k] = occ::normalize(p[k], r.box.lo[k], r.box.inv[k]);
    }
}

// Any G: each lane writes its held group into its slot.
__global__ void __launch_bounds__(THREADS) group_sample_compact_kernel(const Args a) {
    const int G = a.G;
    const int lane = threadIdx.x & 31;
    const int ray = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (ray >= a.n) return;  // whole warps leave together
    const Ray r = load_ray(a, ray);
    const occ::Box vbox = a.vol != nullptr ? occ::load_box(a.vol_aabb) : r.box;
    const long long slot0 = (long long)ray * a.capg;
    float* zo = a.z_c + slot0 * G;
    float* mo = a.vmask + slot0 * G;
    float* xo = a.xyz + slot0 * G * 3;
    const unsigned lower = (1u << lane) - 1u;

    int held = 0;
    for (int g0 = 0; g0 < a.ng && held < a.capg; g0 += 32) {
        const int g = g0 + lane;
        const uint32_t bits = g < a.ng ? group_bits<0>(r, a, vbox, g) : 0u;
        const unsigned ballot = __ballot_sync(0xffffffffu, bits != 0);
        const int slot = held + __popc(ballot & lower);
        if (bits != 0 && slot < a.capg) {
            write_group(r, a, g, bits, zo + slot * G, mo + slot * G, xo + slot * G * 3);
            if (a.idx != nullptr) {
                a.idx[slot0 + slot] = g;
                a.got[slot0 + slot] = 1;
            }
        }
        held += __popc(ballot);
    }
    for (int slot = min(held, a.capg) + lane; slot < a.capg; slot += 32) {
        write_group(r, a, 0, 0u, zo + slot * G, mo + slot * G, xo + slot * G * 3);
        if (a.idx != nullptr) {
            a.idx[slot0 + slot] = 0;
            a.got[slot0 + slot] = 0;
        }
    }
}

// G = 8, the recipe's: a pass's held groups are contiguous slots in every
// output, so each lane stages its group in shared memory (per warp 32
// groups x (2 + 2 + 6) float4, 40 KB a block) and the whole warp writes
// them with contiguous 16-byte stores; the pad slots likewise.
constexpr int STAGE = 32 * 10;

__device__ __forceinline__ void stage_group8(const Ray& r, const Args& a, int g, uint32_t bits,
                                             float4* buf, int pos) {
#pragma unroll
    for (int j0 = 0; j0 < 8; j0 += 4) {
        float z[4], c[12];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            z[j] = depth(r, a, g * 8 + j0 + j);
            float p[3];
            point(r, z[j], p);
#pragma unroll
            for (int k = 0; k < 3; ++k) c[3 * j + k] = occ::normalize(p[k], r.box.lo[k], r.box.inv[k]);
        }
        buf[2 * pos + j0 / 4] = make_float4(z[0], z[1], z[2], z[3]);
        buf[64 + 2 * pos + j0 / 4] = make_float4(
            (bits >> j0) & 1u ? 1.0f : 0.0f, (bits >> (j0 + 1)) & 1u ? 1.0f : 0.0f,
            (bits >> (j0 + 2)) & 1u ? 1.0f : 0.0f, (bits >> (j0 + 3)) & 1u ? 1.0f : 0.0f);
        float4* xv = buf + 128 + 6 * pos + 3 * (j0 / 4);
        xv[0] = make_float4(c[0], c[1], c[2], c[3]);
        xv[1] = make_float4(c[4], c[5], c[6], c[7]);
        xv[2] = make_float4(c[8], c[9], c[10], c[11]);
    }
}

__global__ void __launch_bounds__(THREADS) group_sample_compact_kernel8(const Args a) {
    __shared__ float4 stage[WARPS][STAGE];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int ray = blockIdx.x * WARPS + warp;
    if (ray >= a.n) return;  // whole warps leave together
    float4* buf = stage[warp];
    const Ray r = load_ray(a, ray);
    const occ::Box vbox = a.vol != nullptr ? occ::load_box(a.vol_aabb) : r.box;
    const long long slot0 = (long long)ray * a.capg;
    float4* z4 = reinterpret_cast<float4*>(a.z_c) + slot0 * 2;
    float4* m4 = reinterpret_cast<float4*>(a.vmask) + slot0 * 2;
    float4* x4 = reinterpret_cast<float4*>(a.xyz) + slot0 * 6;
    const unsigned lower = (1u << lane) - 1u;

    int held = 0;
    for (int g0 = 0; g0 < a.ng && held < a.capg; g0 += 32) {
        const int g = g0 + lane;
        const uint32_t bits = g < a.ng ? group_bits<8>(r, a, vbox, g) : 0u;
        const unsigned ballot = __ballot_sync(0xffffffffu, bits != 0);
        const int pos = __popc(ballot & lower);
        const int cnt = min(__popc(ballot), a.capg - held);
        if (bits != 0 && pos < cnt) {
            stage_group8(r, a, g, bits, buf, pos);
            if (a.idx != nullptr) {
                a.idx[slot0 + held + pos] = g;
                a.got[slot0 + held + pos] = 1;
            }
        }
        __syncwarp();
        for (int i = lane; i < 2 * cnt; i += 32) {
            z4[2 * held + i] = buf[i];
            m4[2 * held + i] = buf[64 + i];
        }
        for (int i = lane; i < 6 * cnt; i += 32) x4[6 * held + i] = buf[128 + i];
        __syncwarp();
        held += __popc(ballot);
    }
    const int h = min(held, a.capg);
    if (h < a.capg) {
        if (lane == 0) stage_group8(r, a, 0, 0u, buf, 0);
        __syncwarp();
        const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int i = lane; i < 2 * (a.capg - h); i += 32) {
            z4[2 * h + i] = buf[i & 1];
            m4[2 * h + i] = zero;
        }
        for (int i = lane; i < 6 * (a.capg - h); i += 32) x4[6 * h + i] = buf[128 + i % 6];
        if (a.idx != nullptr) {
            for (int slot = h + lane; slot < a.capg; slot += 32) {
                a.idx[slot0 + slot] = 0;
                a.got[slot0 + slot] = 0;
            }
        }
    }
}

}  // namespace

extern "C" {

// rays: (n, 6) float32 [origin, direction], rows ray_stride floats apart;
// jitter: n floats jitter_stride apart, or null; aabb: (2, 3) float32
// contiguous; volume: (D, H, W) uint8 contiguous with D * H * W < 2^31 and
// vol_aabb its (2, 3) box, or both null; idx and got: (n, capg) or both null;
// z_c, vmask: (n, capg * G) and xyz (n, capg * G, 3), contiguous and 16-byte
// aligned. ng = ceil(S / G); 1 <= G <= 32, 1 <= capg <= ng, n > 0. Launches
// on `stream` and returns the cudaError_t of the launch (0 on success).
int ngf_group_sample_compact(const float* rays, long long ray_stride, const float* jitter,
                             long long jitter_stride, const float* aabb, float near, float far,
                             float step, int n, int S, int G, int capg, const uint8_t* vol, int D,
                             int H, int W, const float* vol_aabb, int* idx, uint8_t* got,
                             float* z_c, float* vmask, float* xyz, void* stream) {
    Args a{rays, ray_stride, jitter, jitter_stride, aabb, near, far, step, n, S, G,
           (S + G - 1) / G, capg, vol, D, H, W, vol_aabb, idx, got, z_c, vmask, xyz};
    const int blocks = (n + WARPS - 1) / WARPS;
    const cudaStream_t s = (cudaStream_t)stream;
    if (G == 8) {
        group_sample_compact_kernel8<<<blocks, THREADS, 0, s>>>(a);
    } else {
        group_sample_compact_kernel<<<blocks, THREADS, 0, s>>>(a);
    }
    return (int)cudaGetLastError();
}

const char* ngf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
