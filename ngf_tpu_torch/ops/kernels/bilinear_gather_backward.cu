// Plane gradient of the bilinear gather, for Hopper (sm_90a).
//
// Replaces the hand-written XLA backward of the plane gather: the plane
// branch of `_duobwd_bwd` (ngf_tpu/ops/grid_sample.py:421-501), which is the
// explicit form of the autodiff of `_grid_sample_2d_blocks` (:196-213). For
// every point n and channel c it adds w_tap(n) * g[n, c] to each of the four
// stencil texels of n (bilinear_stencil.cuh): a scatter-add, the transpose of
// bilinear_gather.cu. A second entry adds the coordinate gradient (K2c, see
// below the plane branch).
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
    static __device__ __forceinline__ float dot(T a, T b) {
        return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
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
    static __device__ __forceinline__ float dot(T a, T b) { return a * b; }
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

// ---------------------------------------------------------------------------
// K2c: the plane gradient and the coordinate gradient of one plane's fetch in
// one pass.
//
// Replaces the coordinate branch of `_duobwd_bwd`
// (ngf_tpu/ops/grid_sample.py:434-455) with `_axis_weight_grads` (:354), the
// gradient that autodiff of `grid_sample_2d` gives the deformed coordinates of
// the learned gauge (ngf_tpu/fields/triplane.py:141-189). With the four taps
// j = 00, 01, 10, 11 (first index y) of a point's stencil and its cotangent g
// over every fetched channel c:
//   t_j = sum_c plane[tap_j, c] * g_c
//   gx  = (t00 wy0 dwx0 + t01 wy0 dwx1 + t10 wy1 dwx0 + t11 wy1 dwx1) (W-1)/2
//   gy  = (t00 dwy0 wx0 + t01 dwy0 wx1 + t10 dwy1 wx0 + t11 dwy1 wx1) (H-1)/2
// and the plane gradient w_j g_c into the four texels, as the plane branch.
//
// Layout. A split fetch has two cotangents: g_a over channels c0 : c0 + split
// and g_b over the rest (either may be the only one), each (N, C_x) float32
// with its own row stride. plane and grad are the (H, W, C_total) float32
// values and gradient, passed offset to channel c0. coord_grad is (N, 2)
// float32, contiguous, written (not added).
//
// Design: the plane branch's segments and lanes. Threads map to (segment of
// SEG consecutive points, channel group of V channels); a thread loads its
// segment's g once and uses it for both gradients: its tap sums go into the
// plane gradient with the plane branch's run merging and atomics, and its
// share of t_j is the dot product of the four taps (re-read from the plane
// only when the stencil start changes) with g. The t_j of a point are summed
// over the segment's lanes by a warp shuffle reduction (the lanes of a segment
// are a power of two up to 32, or whole warps) and, per warp, added into the
// point's slot in shared memory; after a barrier, one thread per point turns
// the four sums into (gx, gy) and stores the pair.
//
// Bound on an H100 SXM: memory, as the plane branch: g read once (N * C * 4
// bytes: 4096 * 512 * 64 * 4 B = 537 MB for one plane of the gauge variant's
// open step), the coordinates read and the coordinate gradient written once
// (16 bytes a point), the plane gradient read and written once. The taps are
// re-read from the 16 MB plane, which the L2 holds. A first design: one
// launch per plane, taps loaded as 16-byte vectors per lane with no staging.
// Measured on an NVIDIA H100 80GB HBM3 at its 700 W limit (PERF.md), it runs
// at about 15% of that bound on the open step, against the plane branch's
// 45%: the float4 variant takes 141 registers a thread, so one 256-thread
// block fits on an SM, and every new stencil start waits on four tap loads.

// Lanes of a segment: the channel groups rounded up to a power of two up to
// 32, or to whole warps beyond, so that a segment's lanes reduce by shuffles.
__host__ __device__ inline int coord_group_threads(int groups) {
    if (groups > 32) return min(((groups + 31) / 32) * 32, MAX_THREADS);
    int t = 1;
    while (t < groups) t *= 2;
    return t;
}

template <int V>
__global__ void __launch_bounds__(MAX_THREADS) bilinear_gather_2d_backward_coords_kernel(
    const float* __restrict__ g_a, long long ga_stride, int groups_a,
    const float* __restrict__ g_b, long long gb_stride, int groups, int group_threads,
    int passes, const float* __restrict__ coords, long long coord_stride_n,
    long long coord_stride_k, const float* __restrict__ plane, long long plane_stride,
    float* __restrict__ grad, long long texel_stride, int H, int W, long long N,
    float* __restrict__ coord_grad) {
    using L = Lanes<V>;
    using T = typename L::T;
    __shared__ int s_start[MAX_TILE];
    __shared__ float4 s_w[MAX_TILE];
    __shared__ float4 s_t[MAX_TILE];

    const int tile = (blockDim.x / group_threads) * SEG;
    const long long first = (long long)blockIdx.x * tile;
    const int npts = (int)min((long long)tile, N - first);
    const int seg = threadIdx.x / group_threads;
    const int lane = threadIdx.x - seg * group_threads;
    const int p0 = seg * SEG;
    const int n = max(0, min(SEG, npts - p0));

    for (int p = threadIdx.x; p < tile; p += blockDim.x) {
        s_t[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (p < npts) {
            const float* cp = coords + (first + p) * coord_stride_n;
            float wx0, wx1, wy0, wy1;
            const int xs = axis_stencil(cp[0], W, &wx0, &wx1);
            const int ys = axis_stencil(cp[coord_stride_k], H, &wy0, &wy1);
            s_start[p] = ys * W + xs;
            s_w[p] = make_float4(wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1);
        }
    }
    __syncthreads();

    // Every thread of a warp runs every pass and point, so that the
    // shuffles see all 32 lanes; a lane past the channel groups, or past the
    // segment's points, contributes zeros.
    const int red = min(group_threads, 32);
    const long long down = (long long)W * texel_stride;
    const long long pdown = (long long)W * plane_stride;
    for (int pass = 0; pass < passes; ++pass) {
        const int cg = lane + pass * group_threads;
        const int nv = cg < groups ? n : 0;
        const float* gp = g_a;
        long long gs = ga_stride;
        if (cg < groups_a) {
            gp = g_a + cg * V;
        } else if (cg < groups) {
            gp = g_b + (cg - groups_a) * V;
            gs = gb_stride;
        }
        T v[SEG];
        load_segment<L>(v, gp + (first + p0) * gs, gs, nv);
        float* dst = grad + cg * V;
        const float* src = plane + cg * V;
        T a00 = L::zero(), a01 = L::zero(), a10 = L::zero(), a11 = L::zero();
        T q00 = L::zero(), q01 = L::zero(), q10 = L::zero(), q11 = L::zero();
        int run = -1;
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
            float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (i < nv) {
                const int s = s_start[p0 + i];
                if (s != run) {
                    if (run >= 0) {
                        end_run<L>(dst + (long long)run * texel_stride, s - run, W,
                                   texel_stride, down, a00, a01, a10, a11);
                    }
                    const float* q = src + (long long)s * plane_stride;
                    q00 = L::load(q);
                    q01 = L::load(q + plane_stride);
                    q10 = L::load(q + pdown);
                    q11 = L::load(q + pdown + plane_stride);
                    run = s;
                }
                const float4 w = s_w[p0 + i];
                a00 = L::fma(w.x, v[i], a00);
                a01 = L::fma(w.y, v[i], a01);
                a10 = L::fma(w.z, v[i], a10);
                a11 = L::fma(w.w, v[i], a11);
                t = make_float4(L::dot(q00, v[i]), L::dot(q01, v[i]), L::dot(q10, v[i]),
                                L::dot(q11, v[i]));
            }
            for (int off = red / 2; off > 0; off >>= 1) {
                t.x += __shfl_xor_sync(0xffffffffu, t.x, off);
                t.y += __shfl_xor_sync(0xffffffffu, t.y, off);
                t.z += __shfl_xor_sync(0xffffffffu, t.z, off);
                t.w += __shfl_xor_sync(0xffffffffu, t.w, off);
            }
            if ((lane & (red - 1)) == 0 && i < n) {
                float4* slot = &s_t[p0 + i];
                atomicAdd(&slot->x, t.x);
                atomicAdd(&slot->y, t.y);
                atomicAdd(&slot->z, t.z);
                atomicAdd(&slot->w, t.w);
            }
        }
        if (run >= 0) {
            add_taps<L>(dst + (long long)run * texel_stride, texel_stride, down, a00, a01, a10,
                        a11);
        }
    }
    __syncthreads();

    const float sx = 0.5f * (float)(W - 1);
    const float sy = 0.5f * (float)(H - 1);
    for (int p = threadIdx.x; p < npts; p += blockDim.x) {
        const float* cp = coords + (first + p) * coord_stride_n;
        float wx0, wx1, wy0, wy1, dwx0, dwx1, dwy0, dwy1;
        axis_stencil_grad(cp[0], W, &wx0, &wx1, &dwx0, &dwx1);
        axis_stencil_grad(cp[coord_stride_k], H, &wy0, &wy1, &dwy0, &dwy1);
        const float4 t = s_t[p];
        const float gx = (t.x * wy0 * dwx0 + t.y * wy0 * dwx1 + t.z * wy1 * dwx0 +
                          t.w * wy1 * dwx1) * sx;
        const float gy = (t.x * dwy0 * wx0 + t.y * dwy0 * wx1 + t.z * dwy1 * wx0 +
                          t.w * dwy1 * wx1) * sy;
        reinterpret_cast<float2*>(coord_grad)[first + p] = make_float2(gx, gy);
    }
}

template <int V>
int launch_coords(const float* g_a, long long ga_stride, int c_a, const float* g_b,
                  long long gb_stride, int c_b, const float* coords, long long coord_stride_n,
                  long long coord_stride_k, const float* plane, long long plane_stride,
                  float* grad, long long texel_stride, int H, int W, long long N,
                  float* coord_grad, cudaStream_t stream) {
    const int groups_a = c_a / V;
    const int groups = groups_a + c_b / V;
    const int group_threads = coord_group_threads(groups);
    const int passes = (groups + group_threads - 1) / group_threads;
    const int segs = min(MAX_THREADS / group_threads, MAX_TILE / SEG);
    const long long tile = (long long)segs * SEG;
    const long long blocks = (N + tile - 1) / tile;
    bilinear_gather_2d_backward_coords_kernel<V>
        <<<(unsigned)blocks, segs * group_threads, 0, stream>>>(
            g_a, ga_stride, groups_a, g_b, gb_stride, groups, group_threads, passes, coords,
            coord_stride_n, coord_stride_k, plane, plane_stride, grad, texel_stride, H, W, N,
            coord_grad);
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

// K2c: adds the plane gradient of one plane's fetch into grad and writes its
// coordinate gradient into coord_grad (N, 2), see above. g_a holds channels
// 0 : c_a of the fetch and g_b channels c_a : c_a + c_b (g_b may be null with
// c_b = 0); plane and grad are offset to the fetch's first channel. vec = 4
// takes float4 loads and atomics and needs c_a, c_b, both g strides, both
// texel strides and every pointer 16-byte aligned; vec = 1 takes any layout.
// Launches on `stream` and returns the cudaError_t of the launch (0 on
// success). N and c_a + c_b must be > 0, H, W >= 2 and H * W < 2^31.
int ngf_bilinear_gather_2d_backward_coords(
    const float* g_a, long long ga_stride, int c_a, const float* g_b, long long gb_stride,
    int c_b, const float* coords, long long coord_stride_n, long long coord_stride_k,
    const float* plane, long long plane_stride, float* grad, long long texel_stride, int H,
    int W, long long N, float* coord_grad, int vec, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (vec == 4 && c_a % 4 == 0 && c_b % 4 == 0) {
        return launch_coords<4>(g_a, ga_stride, c_a, g_b, gb_stride, c_b, coords,
                                coord_stride_n, coord_stride_k, plane, plane_stride, grad,
                                texel_stride, H, W, N, coord_grad, s);
    }
    if (vec == 1) {
        return launch_coords<1>(g_a, ga_stride, c_a, g_b, gb_stride, c_b, coords,
                                coord_stride_n, coord_stride_k, plane, plane_stride, grad,
                                texel_stride, H, W, N, coord_grad, s);
    }
    return (int)cudaErrorInvalidValue;
}

const char* ngf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
