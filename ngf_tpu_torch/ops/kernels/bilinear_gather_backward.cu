// Plane gradient of the bilinear gather, for Hopper (sm_90a).
//
// Replaces the hand-written XLA backward of the plane gather: the plane
// branch of `_duobwd_bwd` (ngf_tpu/ops/grid_sample.py:421-501), which is the
// explicit form of the autodiff of `_grid_sample_2d_blocks` (:196-213). For
// every point n and channel c it adds w_tap(n) * g[n, c] to each of the four
// stencil texels of n (bilinear_stencil.cuh): a scatter-add, the transpose of
// bilinear_gather.cu. No coordinate gradient.
//
// Layout. g is (N, C) float32 with rows g_stride_n elements apart. coords are
// (N, 2) float32 with element strides (coord_stride_n, coord_stride_k), as in
// the forward. grad is the float32 gradient of the whole (H, W, C_total)
// plane, texels texel_stride (= C_total) elements apart, passed as a pointer
// offset by the fetch's first channel: the density (0:24) and appearance
// (24:96) fetches of one plane add into the same buffer, with no
// (H, W, C) intermediate and no copy.
//
// Design: a scatter of merged runs.
// - A block owns a tile of consecutive points and first computes their
//   stencils into shared memory: the start texel ys * W + xs and the four
//   tap weights.
// - Each thread owns one group of V channels (V = 4: one float4) of SEG (16)
//   consecutive points of the tile, its segment. It loads the segment's g
//   values up front, then walks the points in order and keeps the four
//   taps' weighted sums in registers. It adds them into the plane gradient
//   only when the stencil start changes, or at the end of the segment; and
//   when the start moves by one texel along x or y, the two texels that the
//   old and the new stencil share keep their sums, and only the other two
//   are added.
//   A fetch's points arrive ray by ray, sample by sample, half a voxel of the
//   256^3 grid apart, so consecutive points often share a start and with it
//   all four texels (JAX's duo rows merge pairs; this merges runs of any
//   length). Where no two points share a start it adds per point, as a plain
//   scatter does.
// - A tap whose sum is exactly zero for the thread's channels makes no
//   atomic: adding +-0 changes no float. The masked samples of a trained step
//   (zero cotangent rows) and zero-weight taps outside the plane cost a load
//   and no atomic.
// - V = 4 adds with one float4 atomicAdd (sm_90, 16-byte aligned global
//   memory); the wrapper picks it when C, the channel offset, the texel
//   stride, g's row stride and both base pointers are all multiples of 4
//   floats, and V = 1 (scalar atomics, same code) otherwise.
// - Threads map to (segment, channel group) with the group count fixed at
//   launch: one division per thread, none per element.
// Adds run in an order that varies from run to run, so the result is
// deterministic only up to float32 rounding. g goes straight from global
// memory into registers, SEG loads in flight per thread, sent before the
// stencils are computed so that the two overlap; it is not staged through
// shared memory. (32-point segments in two chunks of loads cut the atomics
// by a further eighth and measured no faster.)
//
// Bound on an H100 SXM: memory. g is read once (N * C * 4 bytes), coords once
// (8 bytes a point), the plane gradient read and written once. For the
// appearance fetch of the training step (N = 4096 * 512 = 2,097,152, C = 72)
// that is about 0.65 GB, about 0.19 ms at 3.35 TB/s. Measured on an NVIDIA
// H100 80GB HBM3 at its 700 W limit (PERF.md), the atomics are what this
// kernel waits on, and the L2 takes them at a rate in bytes: float4 atomics
// alone changed little against scalar ones, and the time falls with the tap
// adds per point that merging saves.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear_stencil.cuh"

namespace {

// Consecutive points one thread walks for its channels (its segment); their
// g loads are all in flight at once.
constexpr int SEG = 16;
constexpr int MAX_THREADS = 256;
// Points a block owns at most: 64 segments.
constexpr int MAX_TILE = 64 * SEG;

template <int V>
struct Lanes;

template <>
struct Lanes<4> {
    using T = float4;
    static __device__ __forceinline__ T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
    static __device__ __forceinline__ T load(const float* p) {
        return __ldg(reinterpret_cast<const float4*>(p));
    }
    static __device__ __forceinline__ T fma(float w, T g, T a) {
        return make_float4(fmaf(w, g.x, a.x), fmaf(w, g.y, a.y), fmaf(w, g.z, a.z),
                           fmaf(w, g.w, a.w));
    }
    static __device__ __forceinline__ void add(float* p, T a) {
        if (a.x != 0.0f || a.y != 0.0f || a.z != 0.0f || a.w != 0.0f) {
            atomicAdd(reinterpret_cast<float4*>(p), a);
        }
    }
};

template <>
struct Lanes<1> {
    using T = float;
    static __device__ __forceinline__ T zero() { return 0.0f; }
    static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
    static __device__ __forceinline__ T fma(float w, T g, T a) { return fmaf(w, g, a); }
    static __device__ __forceinline__ void add(float* p, T a) {
        if (a != 0.0f) atomicAdd(p, a);
    }
};

// Adds a run's four tap sums at the stencil whose (y0, x0) texel is t00.
template <typename L>
__device__ __forceinline__ void add_taps(float* t00, long long right, long long down,
                                         typename L::T a00, typename L::T a01,
                                         typename L::T a10, typename L::T a11) {
    L::add(t00, a00);
    L::add(t00 + right, a01);
    L::add(t00 + down, a10);
    L::add(t00 + down + right, a11);
}

// A run ends and the next starts d = s - run texels further on. A step of
// one texel along x or y keeps two of the four texels: their sums carry over
// into the next run's taps, and only the two left behind are added. Any
// other step adds all four (a diagonal step shares one texel; carrying it
// measured no faster).
template <typename L>
__device__ __forceinline__ void end_run(float* t00, int d, int W, long long right,
                                        long long down, typename L::T& a00, typename L::T& a01,
                                        typename L::T& a10, typename L::T& a11) {
    const typename L::T z = L::zero();
    float* t01 = t00 + right;
    float* t10 = t00 + down;
    float* t11 = t10 + right;
    if (d == 1) {  // x + 1: the x1 column becomes the x0 column
        L::add(t00, a00);
        L::add(t10, a10);
        a00 = a01;
        a10 = a11;
        a01 = z;
        a11 = z;
    } else if (d == -1) {
        L::add(t01, a01);
        L::add(t11, a11);
        a01 = a00;
        a11 = a10;
        a00 = z;
        a10 = z;
    } else if (d == W) {  // y + 1: the y1 row becomes the y0 row
        L::add(t00, a00);
        L::add(t01, a01);
        a00 = a10;
        a01 = a11;
        a10 = z;
        a11 = z;
    } else if (d == -W) {
        L::add(t10, a10);
        L::add(t11, a11);
        a10 = a00;
        a11 = a01;
        a00 = z;
        a01 = z;
    } else {
        add_taps<L>(t00, right, down, a00, a01, a10, a11);
        a00 = a01 = a10 = a11 = z;
    }
}

// Loads g of the n points of a segment, zero past n.
template <typename L>
__device__ __forceinline__ void load_segment(typename L::T (&v)[SEG], const float* gp,
                                             long long g_stride_n, int n) {
#pragma unroll
    for (int i = 0; i < SEG; ++i) v[i] = i < n ? L::load(gp + i * g_stride_n) : L::zero();
}

template <int V>
__global__ void __launch_bounds__(MAX_THREADS) bilinear_gather_2d_backward_kernel(
    const float* __restrict__ g, long long g_stride_n, int groups, int group_threads,
    const float* __restrict__ coords, long long coord_stride_n,
    long long coord_stride_k, float* __restrict__ grad, int H, int W,
    long long texel_stride, long long N) {
    using L = Lanes<V>;
    using T = typename L::T;
    __shared__ int s_start[MAX_TILE];
    __shared__ float4 s_w[MAX_TILE];

    const int tile = (blockDim.x / group_threads) * SEG;
    const long long first = (long long)blockIdx.x * tile;
    const int npts = (int)min((long long)tile, N - first);
    const int seg = threadIdx.x / group_threads;
    const int p0 = seg * SEG;
    const int n = min(SEG, npts - p0);
    int cg = threadIdx.x - seg * group_threads;
    const float* gp = g + (first + p0) * g_stride_n;

    // The segment's g values first: their loads are in flight while the
    // block computes the stencils.
    T v[SEG];
    load_segment<L>(v, gp + cg * V, g_stride_n, n);

    for (int p = threadIdx.x; p < npts; p += blockDim.x) {
        const float* cp = coords + (first + p) * coord_stride_n;
        float wx0, wx1, wy0, wy1;
        const int xs = axis_stencil(cp[0], W, &wx0, &wx1);
        const int ys = axis_stencil(cp[coord_stride_k], H, &wy0, &wy1);
        s_start[p] = ys * W + xs;
        s_w[p] = make_float4(wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1);
    }
    __syncthreads();
    if (n <= 0) return;

    const long long down = (long long)W * texel_stride;
    while (true) {
        float* dst = grad + cg * V;
        T a00 = L::zero(), a01 = L::zero(), a10 = L::zero(), a11 = L::zero();
        int run = s_start[p0];
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
            if (i < n) {
                const int s = s_start[p0 + i];
                if (s != run) {
                    end_run<L>(dst + (long long)run * texel_stride, s - run, W, texel_stride,
                               down, a00, a01, a10, a11);
                    run = s;
                }
                const float4 w = s_w[p0 + i];
                a00 = L::fma(w.x, v[i], a00);
                a01 = L::fma(w.y, v[i], a01);
                a10 = L::fma(w.z, v[i], a10);
                a11 = L::fma(w.w, v[i], a11);
            }
        }
        add_taps<L>(dst + (long long)run * texel_stride, texel_stride, down, a00, a01, a10, a11);

        // More channel groups than threads per segment (C > 256 * V only).
        cg += group_threads;
        if (cg >= groups) break;
        load_segment<L>(v, gp + cg * V, g_stride_n, n);
    }
}

template <int V>
int launch(const float* g, long long g_stride_n, int C, const float* coords,
           long long coord_stride_n, long long coord_stride_k, float* grad, int H, int W,
           long long texel_stride, long long N, cudaStream_t stream) {
    const int groups = C / V;
    const int group_threads = min(groups, MAX_THREADS);
    const int segs = min(MAX_THREADS / group_threads, MAX_TILE / SEG);
    const long long tile = (long long)segs * SEG;
    const long long blocks = (N + tile - 1) / tile;
    bilinear_gather_2d_backward_kernel<V><<<(unsigned)blocks, segs * group_threads, 0, stream>>>(
        g, g_stride_n, groups, group_threads, coords, coord_stride_n, coord_stride_k, grad, H,
        W, texel_stride, N);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Adds the gradient of N points into grad (see above). vec = 4 takes float4
// loads and atomics and needs C, g_stride_n, texel_stride and both pointers
// 16-byte aligned; vec = 1 takes any layout. Launches on `stream` and returns
// the cudaError_t of the launch (0 on success). N and C must be > 0 and
// H * W < 2^31.
int ngf_bilinear_gather_2d_backward(const float* g, long long g_stride_n, int C,
                                    const float* coords, long long coord_stride_n,
                                    long long coord_stride_k, float* grad, int H, int W,
                                    long long texel_stride, long long N, int vec,
                                    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (vec == 4 && C % 4 == 0) {
        return launch<4>(g, g_stride_n, C, coords, coord_stride_n, coord_stride_k, grad, H, W,
                         texel_stride, N, s);
    }
    if (vec == 1) {
        return launch<1>(g, g_stride_n, C, coords, coord_stride_n, coord_stride_k, grad, H, W,
                         texel_stride, N, s);
    }
    return (int)cudaErrorInvalidValue;
}

const char* ngf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
