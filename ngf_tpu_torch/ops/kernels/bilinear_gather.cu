// Bilinear gather of up to three channels-last feature planes in one launch,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `pallas_grid_sample_2d` (ngf_tpu/ops/pallas_kernels.py:58,
// body `_bilinear_kernel`) and computes exactly `grid_sample_2d`
// (ngf_tpu/ops/grid_sample.py:216-253) of each plane; the stencil is in
// bilinear_stencil.cuh. One launch fetches channels c0:c1 of P <= 3 planes,
// each at its own coordinates: the fused tri-plane fetch of
// `triplane_density_and_rgbfeat` (ngf_tpu/fields/triplane.py:262-292).
//
// Layout. Plane p is (H_p, W_p, C_p) with texels texel_stride[p] elements
// apart and channels contiguous, passed as a pointer offset by c0: a channel
// slice of a wider plane is no copy. Each plane has its own H_p, W_p >= 2:
// the gauge variant crops its planes to a box and resizes them per axis
// (ngf_tpu/fields/triplane.py:322-350). Its coordinates are (N, 2) float32 with
// element strides (coord_stride_n[p], coord_stride_k[p]), so the projections
// xyz[..., 0:2], xyz[..., 1:3] and xyz[..., 0::2] stay views. The C = c1 - c0
// channels split at s: channels below s go to out_a[n, p, :] (N, P, s) and
// the rest to out_b[n, p, :] (N, P, C - s), both contiguous in the planes'
// type. For the InfoInv tri-plane (C = 96, s = 24) these are density
// (N, 3, 24) and appearance (N, 3, 72): viewed as (N, 72) and (N, 216) they
// are the two decoders' inputs in `torch.cat` order. With s = C there is one
// output; one plane and no split is the single-plane gather.
//
// Design.
// - A block owns a tile of consecutive points. It first computes each
//   (point, plane) stencil once into shared memory, with `axis_stencil`: the
//   start texel ys * W + xs and the four tap weights. Both outputs use it.
// - Each thread owns one 16-byte channel group (V = 4 float32 or 8 bfloat16
//   channels) of one plane for SEG consecutive points, its segment. Threads
//   map to (segment, plane, channel group) once, at launch: no division per
//   element. Groups never straddle s, so each store goes to one output.
// - Walking its points in order, a thread keeps the four tap vectors in
//   registers. A point with the same stencil start as the one before loads
//   nothing; a one-texel step along x or y keeps the two shared texels and
//   loads the other two; any other start loads four. A fetch's points arrive
//   ray by ray, half a voxel apart, so consecutive points mostly share their
//   start or move by one texel: K2's run merging (bilinear_gather_backward.cu)
//   applied to loads.
// - Loads and stores are 16 bytes wide. The wrapper takes the scalar branch
//   of the same template (V = 1) unless C, s, the texel strides and every
//   pointer are 16-byte aligned (`gather_lanes`, ops/cuda_kernels.py). The
//   taps stay in registers in the plane's type (80 registers a thread for
//   bfloat16 where float taps took 122, and more blocks on each SM). Vector
//   stores are marked streaming (`__stcs`): the output, up to gigabytes,
//   should not push the planes out of L2.
// - The sum runs in float32 whatever the plane type, in the tap order
//   (y0, x0), (y0, x1), (y1, x0), (y1, x1) of the plain version.
//
// Bound on an H100 SXM: memory, the output. The fused train fetch
// (N = 4096 * 512 = 2,097,152 points, three 256 x 256 x 96 float32 planes)
// writes N * 3 * 96 * 4 B = 2.42 GB, 0.72 ms at 3.35 TB/s; it reads the
// points once (12 B each: the three projections are views of one xyz) and
// the three 25 MB planes: 0.75 ms in all, against about 4.4 GFLOP of
// arithmetic. On the path's own coordinates (mean run of equal starts
// 1.9-2.5 points, most other steps one texel) the design aims at about
// 1.2-1.4 tap loads per point and channel group, against 4 for a gather
// without reuse; random coordinates need 4 (`run_lengths` in chip_smoke.py
// counts them). The taps come from L2, but three float32 planes (75 MB) do
// not fit its 50 MB: where the rays of a launch spread over the whole view
// (a training batch) or the points are random, part of the taps miss to
// HBM. A grid of one plane per block, plane-major in launch order, keeps
// one plane in L2 but writes each output row in three parts at different
// times; measured on the H100 it lost more than it saved (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "bilinear_stencil.cuh"

namespace {

// Consecutive points one thread walks for its channel group.
constexpr int SEG = 32;
constexpr int MAX_THREADS = 256;
constexpr int MAX_PLANES = 3;
// (point, plane) stencils a block holds in shared memory.
constexpr int MAX_ENTRIES = 1024;

struct Planes {
    const void* plane[MAX_PLANES];  // offset to the first fetched channel
    long long texel_stride[MAX_PLANES];
    const float* coords[MAX_PLANES];
    long long coord_stride_n[MAX_PLANES];
    long long coord_stride_k[MAX_PLANES];
    int H[MAX_PLANES];
    int W[MAX_PLANES];
};

// Element p of a per-plane field by selects, so that a run-time plane index
// does not copy the kernel's arguments to local memory.
template <typename X>
__device__ __forceinline__ X pick(const X (&a)[MAX_PLANES], int p) {
    return p == 0 ? a[0] : (p == 1 ? a[1] : a[2]);
}

// V channels of type T: a 16-byte (or scalar) load into registers as they
// lie in memory (Raw), channel c of it as float, and a store of V floats.
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
    using Raw = float4;
    static __device__ __forceinline__ Raw load(const float* p) {
        return __ldg(reinterpret_cast<const float4*>(p));
    }
    static __device__ __forceinline__ float get(const Raw& r, int c) {
        return c == 0 ? r.x : (c == 1 ? r.y : (c == 2 ? r.z : r.w));
    }
    static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
        __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    }
};

template <>
struct Vec<float, 1> {
    using Raw = float;
    static __device__ __forceinline__ Raw load(const float* p) { return __ldg(p); }
    static __device__ __forceinline__ float get(const Raw& r, int) { return r; }
    static __device__ __forceinline__ void store(float* p, const float (&v)[1]) { *p = v[0]; }
};

// bfloat16 pairs in a 32-bit word, the lower address in the low half.
__device__ __forceinline__ unsigned bf16_pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
}

template <>
struct Vec<__nv_bfloat16, 8> {
    using Raw = uint4;
    static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
        return __ldg(reinterpret_cast<const uint4*>(p));
    }
    static __device__ __forceinline__ float get(const Raw& r, int c) {
        const unsigned w = c < 2 ? r.x : (c < 4 ? r.y : (c < 6 ? r.z : r.w));
        return __uint_as_float((c & 1) ? (w & 0xffff0000u) : (w << 16));
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
        __stcs(reinterpret_cast<uint4*>(p), make_uint4(bf16_pack(v[0], v[1]), bf16_pack(v[2], v[3]),
                                                       bf16_pack(v[4], v[5]), bf16_pack(v[6], v[7])));
    }
};

template <>
struct Vec<__nv_bfloat16, 1> {
    using Raw = unsigned short;
    static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
        return __ldg(reinterpret_cast<const unsigned short*>(p));
    }
    static __device__ __forceinline__ float get(const Raw& r, int) {
        return __uint_as_float((unsigned)r << 16);
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
        *p = __float2bfloat16(v[0]);
    }
};

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS) bilinear_gather_planes_kernel(
    const Planes pl, int P, int groups_a, int groups_b, int split, int rest,
    int seg_threads, T* __restrict__ out_a, T* __restrict__ out_b, long long N) {
    using L = Vec<T, V>;
    __shared__ int s_start[MAX_ENTRIES];
    __shared__ float4 s_w[MAX_ENTRIES];

    const int tile = (blockDim.x / seg_threads) * SEG;
    const long long first = (long long)blockIdx.x * tile;
    const int npts = (int)min((long long)tile, N - first);

    // Each (point, plane) stencil once: entry plane * tile + point.
    for (int e = threadIdx.x; e < P * tile; e += blockDim.x) {
        const int p = e / tile;
        const int i = e - p * tile;
        if (i < npts) {
            const float* cp = pick(pl.coords, p) + (first + i) * pick(pl.coord_stride_n, p);
            const int W = pick(pl.W, p);
            float wx0, wx1, wy0, wy1;
            const int xs = axis_stencil(__ldg(cp), W, &wx0, &wx1);
            const int ys = axis_stencil(__ldg(cp + pick(pl.coord_stride_k, p)), pick(pl.H, p), &wy0,
                                        &wy1);
            s_start[e] = ys * W + xs;
            s_w[e] = make_float4(wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1);
        }
    }
    __syncthreads();

    const int seg = threadIdx.x / seg_threads;
    const int p0 = seg * SEG;
    const int n = min(SEG, npts - p0);
    if (n <= 0) return;
    const int groups = groups_a + groups_b;

    // Lanes j of a segment: plane j / groups, then its channel groups in
    // order, those below s first. More lanes than threads per segment only
    // when P * C > 256 * V.
    for (int j = threadIdx.x - seg * seg_threads; j < P * groups; j += seg_threads) {
        const int p = j / groups;
        const int g = j - p * groups;
        T* dst;
        long long row;
        if (g < groups_a) {
            dst = out_a + (long long)p * split + g * V;
            row = (long long)P * split;
        } else {
            dst = out_b + (long long)p * rest + (g - groups_a) * V;
            row = (long long)P * rest;
        }
        dst += (first + p0) * row;
        const T* src = static_cast<const T*>(pick(pl.plane, p)) + g * V;
        const int W = pick(pl.W, p);
        const long long right = pick(pl.texel_stride, p);
        const long long down = (long long)W * right;
        const int* starts = s_start + p * tile + p0;
        const float4* ws = s_w + p * tile + p0;

        typename L::Raw t00, t01, t10, t11;
        int run = starts[0];
        {
            const T* t = src + (long long)run * right;
            t00 = L::load(t);
            t01 = L::load(t + right);
            t10 = L::load(t + down);
            t11 = L::load(t + down + right);
        }
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
            const int s = starts[i];
            if (s != run) {
                const int d = s - run;
                const T* t = src + (long long)s * right;
                if (d == 1) {  // x + 1: the x1 column becomes the x0 column
                    t00 = t01;
                    t10 = t11;
                    t01 = L::load(t + right);
                    t11 = L::load(t + down + right);
                } else if (d == -1) {
                    t01 = t00;
                    t11 = t10;
                    t00 = L::load(t);
                    t10 = L::load(t + down);
                } else if (d == W) {  // y + 1: the y1 row becomes the y0 row
                    t00 = t10;
                    t01 = t11;
                    t10 = L::load(t + down);
                    t11 = L::load(t + down + right);
                } else if (d == -W) {
                    t10 = t00;
                    t11 = t01;
                    t00 = L::load(t);
                    t01 = L::load(t + right);
                } else {
                    t00 = L::load(t);
                    t01 = L::load(t + right);
                    t10 = L::load(t + down);
                    t11 = L::load(t + down + right);
                }
                run = s;
            }
            const float4 w = ws[i];
            float acc[V];
#pragma unroll
            for (int c = 0; c < V; ++c) {
                acc[c] = w.x * L::get(t00, c);
                acc[c] += w.y * L::get(t01, c);
                acc[c] += w.z * L::get(t10, c);
                acc[c] += w.w * L::get(t11, c);
            }
            L::store(dst + i * row, acc);
        }
    }
}

template <typename T, int V>
int launch(const Planes& pl, int P, int C, int split, void* out_a, void* out_b,
           long long N, cudaStream_t stream) {
    const int groups_a = split / V;
    const int groups_b = (C - split) / V;
    const int seg_threads = min(P * (groups_a + groups_b), MAX_THREADS);
    const int segs = max(1, min(MAX_THREADS / seg_threads, MAX_ENTRIES / (P * SEG)));
    const long long tile = (long long)segs * SEG;
    const long long blocks = (N + tile - 1) / tile;
    bilinear_gather_planes_kernel<T, V><<<(unsigned)blocks, segs * seg_threads, 0, stream>>>(
        pl, P, groups_a, groups_b, split, C - split, seg_threads, static_cast<T*>(out_a),
        static_cast<T*>(out_b), N);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// desc holds P rows of seven values: the plane's pointer (offset to channel
// c0), its texel stride, the coordinates' pointer, their two element
// strides, and the plane's H and W. dtype: 0 = float32, 1 = bfloat16.
// vec = 16 / sizeof(dtype) takes 16-byte loads and stores and needs C,
// split, every texel stride and every pointer 16-byte aligned; vec = 1
// takes any layout. out_b may be null when
// split == C. Launches on `stream` and returns the cudaError_t of the launch
// (0 on success). N and C must be > 0, 0 < split <= C, every H, W >= 2 and
// H * W < 2^31.
int ngf_bilinear_gather_planes(const long long* desc, int P, int C, int split,
                               void* out_a, void* out_b, long long N, int dtype, int vec,
                               void* stream) {
    if (P < 1 || P > MAX_PLANES || split < 1 || split > C) return (int)cudaErrorInvalidValue;
    Planes pl = {};
    for (int p = 0; p < P; ++p) {
        const long long* d = desc + 7 * p;
        pl.plane[p] = reinterpret_cast<const void*>(d[0]);
        pl.texel_stride[p] = d[1];
        pl.coords[p] = reinterpret_cast<const float*>(d[2]);
        pl.coord_stride_n[p] = d[3];
        pl.coord_stride_k[p] = d[4];
        pl.H[p] = (int)d[5];
        pl.W[p] = (int)d[6];
    }
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0 && vec == 4) return launch<float, 4>(pl, P, C, split, out_a, out_b, N, s);
    if (dtype == 0 && vec == 1) return launch<float, 1>(pl, P, C, split, out_a, out_b, N, s);
    if (dtype == 1 && vec == 8) {
        return launch<__nv_bfloat16, 8>(pl, P, C, split, out_a, out_b, N, s);
    }
    if (dtype == 1 && vec == 1) {
        return launch<__nv_bfloat16, 1>(pl, P, C, split, out_a, out_b, N, s);
    }
    return (int)cudaErrorInvalidValue;
}

const char* ngf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
