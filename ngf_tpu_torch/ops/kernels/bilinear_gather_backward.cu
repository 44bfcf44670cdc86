// Plane gradient of the bilinear gather, for Hopper (sm_90a).
//
// Replaces the hand-written XLA backward of the plane gather: the plane
// branch of `_duobwd_bwd` (ngf_tpu/ops/grid_sample.py:421-501), which is the
// explicit form of the autodiff of `_grid_sample_2d_blocks` (:196-213). For
// every point n and channel c it adds w_tap(n) * g[n, c] to each of the four
// stencil texels of n (bilinear_stencil.cuh): a scatter-add, the transpose of
// bilinear_gather.cu. A second entry, K2c, adds the plane gradient and
// writes the coordinate gradient of a fetch of up to three planes (see below
// the plane branch).
//
// Layout. g is (N, C) float32 or bfloat16 with rows g_stride_n elements apart. coords are
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
//   stride and g's row stride are multiples of 4 elements, g's base pointer
//   is aligned to a 4-channel load and the gradient's to 16 bytes, and V = 1
//   (scalar atomics, same code) otherwise.
// - Threads map to (segment, channel group) with the group count fixed at
//   launch: one division per thread, none per element.
// - A bfloat16 g (the bfloat16 recipe's cotangents) is read as it lies, 4
//   channels an 8-byte load (V = 4) or one (V = 1), and widened to float32
//   before the multiply; the plane gradient, the sums and the float4
//   atomics stay float32, and so do the weights. The lanes and threads are
//   those of float32 at the same C, with half the registers for g: 94
//   registers, two blocks an SM (an 8-channel lane, two float4 sums a tap,
//   held 156 registers, one block an SM, and took 1.5 times as long:
//   PERF.md). The float32 sums round less than the JAX package's bfloat16
//   fetch, whose vjp multiplies by weights rounded to bfloat16 and
//   scatter-adds in bfloat16 (tests/test_torch_bf16.py measures both
//   against a float64 gradient). A bfloat16 gradient buffer would lose the
//   small taps of a texel's thousands of adds.
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

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
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

// A lane's V channels of g (or of a plane) of element type G: `T` as they
// lie in memory, `A` their float32 sums. load reads them, fma adds w * g to
// the sums, add adds the sums into the float32 gradient (no atomic for an
// all-zero sum: adding +-0 changes no float), dot is sum_c q_c g_c in float32.
template <typename G, int V>
struct Lanes;

template <>
struct Lanes<float, 4> {
    using T = float4;
    using A = float4;
    static __device__ __forceinline__ T none() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
    static __device__ __forceinline__ A zero() { return none(); }
    static __device__ __forceinline__ T load(const float* p) {
        return __ldg(reinterpret_cast<const float4*>(p));
    }
    static __device__ __forceinline__ A fma(float w, T g, A a) {
        return make_float4(fmaf(w, g.x, a.x), fmaf(w, g.y, a.y), fmaf(w, g.z, a.z),
                           fmaf(w, g.w, a.w));
    }
    static __device__ __forceinline__ void add(float* p, A a) {
        if (a.x != 0.0f || a.y != 0.0f || a.z != 0.0f || a.w != 0.0f) {
            atomicAdd(reinterpret_cast<float4*>(p), a);
        }
    }
    static __device__ __forceinline__ float dot(T a, T b) {
        return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
    }
};

template <>
struct Lanes<float, 1> {
    using T = float;
    using A = float;
    static __device__ __forceinline__ T none() { return 0.0f; }
    static __device__ __forceinline__ A zero() { return 0.0f; }
    static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
    static __device__ __forceinline__ A fma(float w, T g, A a) { return fmaf(w, g, a); }
    static __device__ __forceinline__ void add(float* p, A a) {
        if (a != 0.0f) atomicAdd(p, a);
    }
    static __device__ __forceinline__ float dot(T a, T b) { return a * b; }
};

// The bfloat16 of a 32-bit word's low (lower address) or high half, as float.
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// Four bfloat16 channels a lane, one 8-byte load (the bfloat16 lanes of K2
// and K2c), whose float32 sums are one float4 as at float32.
template <>
struct Lanes<__nv_bfloat16, 4> {
    using T = uint2;
    using A = float4;
    static __device__ __forceinline__ T none() { return make_uint2(0u, 0u); }
    static __device__ __forceinline__ A zero() { return Lanes<float, 4>::zero(); }
    static __device__ __forceinline__ T load(const __nv_bfloat16* p) {
        return __ldg(reinterpret_cast<const uint2*>(p));
    }
    static __device__ __forceinline__ A fma(float w, T g, A a) {
        return make_float4(fmaf(w, bf16_lo(g.x), a.x), fmaf(w, bf16_hi(g.x), a.y),
                           fmaf(w, bf16_lo(g.y), a.z), fmaf(w, bf16_hi(g.y), a.w));
    }
    static __device__ __forceinline__ void add(float* p, A a) { Lanes<float, 4>::add(p, a); }
    static __device__ __forceinline__ float dot(T a, T b) {
        return bf16_lo(a.x) * bf16_lo(b.x) + bf16_hi(a.x) * bf16_hi(b.x) +
               bf16_lo(a.y) * bf16_lo(b.y) + bf16_hi(a.y) * bf16_hi(b.y);
    }
};

template <>
struct Lanes<__nv_bfloat16, 1> {
    using T = unsigned short;
    using A = float;
    static __device__ __forceinline__ T none() { return 0; }
    static __device__ __forceinline__ A zero() { return 0.0f; }
    static __device__ __forceinline__ T load(const __nv_bfloat16* p) {
        return __ldg(reinterpret_cast<const unsigned short*>(p));
    }
    static __device__ __forceinline__ A fma(float w, T g, A a) {
        return fmaf(w, bf16_lo(g), a);
    }
    static __device__ __forceinline__ void add(float* p, A a) { Lanes<float, 1>::add(p, a); }
    static __device__ __forceinline__ float dot(T a, T b) { return bf16_lo(a) * bf16_lo(b); }
};

// Adds a run's four tap sums at the stencil whose (y0, x0) texel is t00.
template <typename L>
__device__ __forceinline__ void add_taps(float* t00, long long right, long long down,
                                         typename L::A a00, typename L::A a01,
                                         typename L::A a10, typename L::A a11) {
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
                                        long long down, typename L::A& a00, typename L::A& a01,
                                        typename L::A& a10, typename L::A& a11) {
    const typename L::A z = L::zero();
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
template <typename L, typename G>
__device__ __forceinline__ void load_segment(typename L::T (&v)[SEG], const G* gp,
                                             long long g_stride_n, int n) {
#pragma unroll
    for (int i = 0; i < SEG; ++i) v[i] = i < n ? L::load(gp + i * g_stride_n) : L::none();
}

template <typename G, int V>
__global__ void __launch_bounds__(MAX_THREADS) bilinear_gather_2d_backward_kernel(
    const G* __restrict__ g, long long g_stride_n, int groups, int group_threads,
    const float* __restrict__ coords, long long coord_stride_n,
    long long coord_stride_k, float* __restrict__ grad, int H, int W,
    long long texel_stride, long long N) {
    using L = Lanes<G, V>;
    using T = typename L::T;
    using A = typename L::A;
    __shared__ int s_start[MAX_TILE];
    __shared__ float4 s_w[MAX_TILE];

    const int tile = (blockDim.x / group_threads) * SEG;
    const long long first = (long long)blockIdx.x * tile;
    const int npts = (int)min((long long)tile, N - first);
    const int seg = threadIdx.x / group_threads;
    const int p0 = seg * SEG;
    const int n = min(SEG, npts - p0);
    int cg = threadIdx.x - seg * group_threads;
    const G* gp = g + (first + p0) * g_stride_n;

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
        A a00 = L::zero(), a01 = L::zero(), a10 = L::zero(), a11 = L::zero();
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

template <typename G, int V>
int launch(const G* g, long long g_stride_n, int C, const float* coords,
           long long coord_stride_n, long long coord_stride_k, float* grad, int H, int W,
           long long texel_stride, long long N, cudaStream_t stream) {
    const int groups = C / V;
    const int group_threads = min(groups, MAX_THREADS);
    const int segs = min(MAX_THREADS / group_threads, MAX_TILE / SEG);
    const long long tile = (long long)segs * SEG;
    const long long blocks = (N + tile - 1) / tile;
    bilinear_gather_2d_backward_kernel<G, V><<<(unsigned)blocks, segs * group_threads, 0, stream>>>(
        g, g_stride_n, groups, group_threads, coords, coord_stride_n, coord_stride_k, grad, H,
        W, texel_stride, N);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2c: the plane gradient and the coordinate gradient of a fetch of up to
// three planes, in one launch.
//
// Replaces the coordinate branch of `_duobwd_bwd`
// (ngf_tpu/ops/grid_sample.py:434-455) with `_axis_weight_grads` (:354),
// together with the plane branch (:457-501), for each plane of the learned
// gauge's fetch at its deformed coordinates (ngf_tpu/fields/triplane.py:141-189).
// With the four taps j = 00, 01, 10, 11 (first index y) of a point's stencil
// and its cotangent g over every fetched channel c:
//   t_j = sum_c plane[tap_j, c] * g_c
//   gx  = (t00 wy0 dwx0 + t01 wy0 dwx1 + t10 wy1 dwx0 + t11 wy1 dwx1) (W-1)/2
//   gy  = (t00 dwy0 wx0 + t01 dwy0 wx1 + t10 dwy1 wx0 + t11 dwy1 wx1) (H-1)/2
// and the plane gradient w_j g_c into the four texels, as the plane branch.
//
// Layout. Plane p < P <= 3 has its own H_p, W_p (the gauge's planes after
// the shrink and upsample): its values and its gradient are (H_p, W_p,
// C_total) float32, texels texel_stride elements apart, passed offset to the
// fetch's first channel c0, and its coordinates (N, 2) float32 with element
// strides (coord_stride_n, coord_stride_k), as in the gather
// (bilinear_gather.cu). The cotangents are the gradients of the fetch's two
// outputs as they lie: g_a (N, P, C_a) over channels c0 : c0 + C_a and g_b
// (N, P, C_b) over the next C_b (either may be the only one), each with its
// own point and plane strides. coord_grad is (N, P, 2) float32, contiguous,
// written (not added).
//
// Design.
// - One launch: a grid of (tile, plane) blocks. A block owns one plane's
//   tile of consecutive points and first computes their stencils into
//   shared memory: the start texel, the four tap weights, and the weights'
//   derivatives folded with the axis scale, kx_j = wy * dwx * (W-1)/2 and
//   ky_j = dwy * wx * (H-1)/2.
// - Threads map to (segment of COORD_SEG consecutive points, channel group
//   of V channels), as in the plane branch, with the plane branch's run
//   merging, `end_run` carry-over, float4 atomics and zero-sum skip.
// - A lane's g values reach it through a ring of STAGES slots in shared
//   memory, filled by `cp.async` copies STAGES - 1 points ahead, not through
//   registers: with no segment of g in registers the kernel fits three
//   256-thread blocks on an SM (`__launch_bounds__(256, 3)`: at most 80
//   registers a thread, 24 warps an SM), and the copies in flight cost no
//   registers.
// - On a new stencil start the lane issues the four tap loads of the plane
//   first (two where the start moves one texel along x or y, as in the
//   gather), then the last run's atomics, so that the loads are in flight
//   while the atomics go out.
// - Each lane folds the derivatives into its partial sums before the
//   reduction, u_x = sum_j kx_j t_j and u_y = sum_j ky_j t_j over its
//   channels, so a point reduces two sums over the segment's lanes, not
//   four. Where a segment's lanes lie in one warp (C <= 128 at float4) the
//   reducing lane stores (gx, gy) itself; segments of whole warps add their
//   warps' sums in shared memory and store after a barrier.
//
// Bound on an H100 SXM: memory. g read once (N * C * 4 bytes a plane), the
// coordinates read and the coordinate gradient written once (16 bytes a
// point and plane), the plane gradient read and written and the plane read
// once. For the gauge's open step (three 256 x 256 x 64 planes, N = 4096 *
// 512) that is about 1.86 GB, 0.556 ms at 3.35 TB/s. Measured on an NVIDIA
// H100 80GB HBM3 at its 700 W limit (PERF.md), it runs at about 41% of that
// bound there and 50% on a trained gauge step's fetch, where the first
// design (a launch a plane, 141 registers, one block an SM) ran at 15-18%.
// Like the plane branch, it waits on the L2's atomics; on random points,
// where every point starts a new stencil and three planes' gradients exceed
// the L2, it reaches 16%.
//
// bfloat16 (the learned gauge's bfloat16 recipe). The fetched planes' values
// and both cotangents are bfloat16 (the values are the very copy the forward
// fetched, so the backward sees the forward's texels); the coordinates, the
// weights, the tap sums t_j, the coordinate gradient and the plane gradients
// stay float32. A lane holds 4 channels, one 8-byte load of g or of a tap
// (V = 4, not 8): the lane grouping of the float32 variant (16 lanes a point
// at C = 64), float4 atomics as there, and half its registers for taps and
// ring slots, so the variant keeps three blocks an SM; the ring's slots are
// 8 bytes. Where an access is not 8-byte aligned, one channel a lane (V = 1):
// cp.async copies 4, 8 or 16 bytes, so that variant's 2-byte g goes through
// its ring slot by an ordinary load and store.

// The consecutive points a K2c lane walks, the blocks meant to share an SM
// and the slots of a lane's ring of g values in shared memory. PERF.md
// records the alternatives measured (8 points a lane, 2 blocks an SM, 2 or 8
// slots, the tap loads after the atomics) and why these were kept.
constexpr int COORD_SEG = 16;
constexpr int COORD_BLOCKS_PER_SM = 3;
constexpr int STAGES = 4;
// Points a K2c block owns at most: 16 segments.
constexpr int COORD_TILE = 16 * COORD_SEG;
constexpr int MAX_PLANES = 3;

struct CoordPlanes {
    const void* plane[MAX_PLANES];   // values (g's type), offset to the first fetched channel
    float* grad[MAX_PLANES];         // gradient, offset alike
    const float* coords[MAX_PLANES];
    long long coord_stride_n[MAX_PLANES];
    long long coord_stride_k[MAX_PLANES];
    int plane_stride[MAX_PLANES];    // texel strides, in elements
    int grad_stride[MAX_PLANES];
    int H[MAX_PLANES];
    int W[MAX_PLANES];
};

// Element p of a per-plane field by selects, so that a run-time plane index
// does not copy the kernel's arguments to local memory.
template <typename X>
__device__ __forceinline__ X pick(const X (&a)[MAX_PLANES], int p) {
    return p == 0 ? a[0] : (p == 1 ? a[1] : a[2]);
}

// The four taps of the stencil at texel s. A step of d = s - run = +-1 or
// +-W keeps the two taps the new stencil shares with the last one; d = 0
// (no last stencil) or any other step loads all four.
template <typename L, typename G>
__device__ __forceinline__ void load_taps(const G* src, int s, int d, int W, int right,
                                          int down, typename L::T& q00, typename L::T& q01,
                                          typename L::T& q10, typename L::T& q11) {
    const G* t = src + (long long)s * right;
    if (d == 1) {  // x + 1: the x1 column becomes the x0 column
        q00 = q01;
        q10 = q11;
        q01 = L::load(t + right);
        q11 = L::load(t + down + right);
    } else if (d == -1) {
        q01 = q00;
        q11 = q10;
        q00 = L::load(t);
        q10 = L::load(t + down);
    } else if (d == W) {  // y + 1: the y1 row becomes the y0 row
        q00 = q10;
        q01 = q11;
        q10 = L::load(t + down);
        q11 = L::load(t + down + right);
    } else if (d == -W) {
        q10 = q00;
        q11 = q01;
        q00 = L::load(t);
        q01 = L::load(t + right);
    } else {
        q00 = L::load(t);
        q01 = L::load(t + right);
        q10 = L::load(t + down);
        q11 = L::load(t + down + right);
    }
}

// Lanes of a segment: the channel groups rounded up to a power of two up to
// 32, or to whole warps beyond, so that a segment's lanes reduce by shuffles.
__host__ __device__ inline int coord_group_threads(int groups) {
    if (groups > 32) return min(((groups + 31) / 32) * 32, MAX_THREADS);
    int t = 1;
    while (t < groups) t *= 2;
    return t;
}

// One element of g into the lane's ring slot: by cp.async where the element
// is 4, 8 or 16 bytes, else by the thread itself (it alone reads the slot).
template <typename T>
__device__ __forceinline__ void copy_ahead(T* dst, const T* src) {
    if constexpr (sizeof(T) >= 4) {
        __pipeline_memcpy_async(dst, src, sizeof(T));
    } else {
        *dst = *src;
    }
}

template <typename G, int V>
__global__ void __launch_bounds__(MAX_THREADS, COORD_BLOCKS_PER_SM)
    bilinear_gather_planes_backward_coords_kernel(
        const CoordPlanes pl, const G* __restrict__ g_a, long long ga_stride_n,
        long long ga_stride_p, int groups_a, const G* __restrict__ g_b,
        long long gb_stride_n, long long gb_stride_p, int groups, int group_threads, int passes,
        long long N, float2* __restrict__ coord_grad) {
    using L = Lanes<G, V>;
    using T = typename L::T;
    using A = typename L::A;
    __shared__ int s_start[COORD_TILE];
    __shared__ float4 s_w[COORD_TILE];
    __shared__ float4 s_kx[COORD_TILE];
    __shared__ float4 s_ky[COORD_TILE];
    __shared__ float2 s_u[COORD_TILE];
    __shared__ T s_g[STAGES][MAX_THREADS];

    const int P = gridDim.y;
    const int p = blockIdx.y;
    const int W = pick(pl.W, p);
    const int tile = (blockDim.x / group_threads) * COORD_SEG;
    const long long first = (long long)blockIdx.x * tile;
    const int npts = (int)min((long long)tile, N - first);
    {
        const int H = pick(pl.H, p);
        const float* coords = pick(pl.coords, p);
        const long long csn = pick(pl.coord_stride_n, p);
        const long long csk = pick(pl.coord_stride_k, p);
        const float sx = 0.5f * (float)(W - 1);
        const float sy = 0.5f * (float)(H - 1);
        for (int i = threadIdx.x; i < tile; i += blockDim.x) {
            s_u[i] = make_float2(0.0f, 0.0f);
            if (i < npts) {
                const float* cp = coords + (first + i) * csn;
                float wx0, wx1, wy0, wy1, dwx0, dwx1, dwy0, dwy1;
                const int xs = axis_stencil_grad(__ldg(cp), W, &wx0, &wx1, &dwx0, &dwx1);
                const int ys = axis_stencil_grad(__ldg(cp + csk), H, &wy0, &wy1, &dwy0, &dwy1);
                s_start[i] = ys * W + xs;
                s_w[i] = make_float4(wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1);
                s_kx[i] = make_float4(wy0 * dwx0 * sx, wy0 * dwx1 * sx, wy1 * dwx0 * sx,
                                      wy1 * dwx1 * sx);
                s_ky[i] = make_float4(dwy0 * wx0 * sy, dwy0 * wx1 * sy, dwy1 * wx0 * sy,
                                      dwy1 * wx1 * sy);
            }
        }
    }
    __syncthreads();

    const int seg = threadIdx.x / group_threads;
    const int lane = threadIdx.x - seg * group_threads;
    const int p0 = seg * COORD_SEG;
    const int n = max(0, min(COORD_SEG, npts - p0));
    float2* out = coord_grad + (first + p0) * P + p;
    // Every thread of a warp runs every pass and point, so that the
    // shuffles see all 32 lanes; a lane past the channel groups, or past the
    // segment's points, adds zeros.
    const int red = min(group_threads, 32);
    const bool direct = group_threads <= 32;
    const int right = pick(pl.grad_stride, p);
    const int pright = pick(pl.plane_stride, p);
    for (int pass = 0; pass < passes; ++pass) {
        const int cg = lane + pass * group_threads;
        const int nv = cg < groups ? n : 0;
        const bool in_a = cg < groups_a;
        const long long gs = in_a ? ga_stride_n : gb_stride_n;
        const G* gp = (in_a ? g_a + p * ga_stride_p + cg * V
                            : g_b + p * gb_stride_p + (cg - groups_a) * V) +
                      (first + p0) * gs;
        float* dst = pick(pl.grad, p) + cg * V;
        const G* src = static_cast<const G*>(pick(pl.plane, p)) + cg * V;
        A a00 = L::zero(), a01 = L::zero(), a10 = L::zero(), a11 = L::zero();
        T q00 = L::none(), q01 = L::none(), q10 = L::none(), q11 = L::none();
        // The lane's g values pass through its ring of STAGES slots in
        // shared memory: the copy of point i + STAGES - 1 goes out before
        // point i is used.
        T* ring = &s_g[0][threadIdx.x];
        for (int k = 0; k < STAGES - 1; ++k) {
            if (k < nv) copy_ahead(ring + k * MAX_THREADS, reinterpret_cast<const T*>(gp + k * gs));
            __pipeline_commit();
        }
        int run = -1;
        for (int i = 0; i < COORD_SEG; ++i) {
            const int k = i + STAGES - 1;
            if (k < nv) {
                copy_ahead(ring + (k % STAGES) * MAX_THREADS, reinterpret_cast<const T*>(gp + k * gs));
            }
            __pipeline_commit();
            __pipeline_wait_prior(STAGES - 1);
            float ux = 0.0f, uy = 0.0f;
            if (i < nv) {
                const T v = ring[(i % STAGES) * MAX_THREADS];
                const int s = s_start[p0 + i];
                if (s != run) {
                    const int d = run < 0 ? 0 : s - run;
                    load_taps<L>(src, s, d, W, pright, W * pright, q00, q01, q10, q11);
                    if (run >= 0) {
                        end_run<L>(dst + (long long)run * right, d, W, right,
                                   (long long)W * right, a00, a01, a10, a11);
                    }
                    run = s;
                }
                const float4 w = s_w[p0 + i];
                a00 = L::fma(w.x, v, a00);
                a01 = L::fma(w.y, v, a01);
                a10 = L::fma(w.z, v, a10);
                a11 = L::fma(w.w, v, a11);
                const float t00 = L::dot(q00, v), t01 = L::dot(q01, v);
                const float t10 = L::dot(q10, v), t11 = L::dot(q11, v);
                const float4 kx = s_kx[p0 + i];
                ux = kx.x * t00 + kx.y * t01 + kx.z * t10 + kx.w * t11;
                const float4 ky = s_ky[p0 + i];
                uy = ky.x * t00 + ky.y * t01 + ky.z * t10 + ky.w * t11;
            }
            for (int off = red / 2; off > 0; off >>= 1) {
                ux += __shfl_xor_sync(0xffffffffu, ux, off);
                uy += __shfl_xor_sync(0xffffffffu, uy, off);
            }
            if ((lane & (red - 1)) == 0 && i < n) {
                if (direct) {
                    out[i * P] = make_float2(ux, uy);
                } else {
                    atomicAdd(&s_u[p0 + i].x, ux);
                    atomicAdd(&s_u[p0 + i].y, uy);
                }
            }
        }
        if (run >= 0) {
            add_taps<L>(dst + (long long)run * right, right, (long long)W * right, a00, a01, a10,
                        a11);
        }
    }
    if (!direct) {  // uniform over the block
        __syncthreads();
        for (int i = threadIdx.x; i < npts; i += blockDim.x) {
            coord_grad[(first + i) * P + p] = s_u[i];
        }
    }
}

template <typename G, int V>
int launch_coords(const CoordPlanes& pl, int P, const G* g_a, long long ga_stride_n,
                  long long ga_stride_p, int c_a, const G* g_b, long long gb_stride_n,
                  long long gb_stride_p, int c_b, long long N, float* coord_grad,
                  cudaStream_t stream) {
    const int groups_a = c_a / V;
    const int groups = groups_a + c_b / V;
    const int group_threads = coord_group_threads(groups);
    const int passes = (groups + group_threads - 1) / group_threads;
    const int segs = min(MAX_THREADS / group_threads, COORD_TILE / COORD_SEG);
    const long long tile = (long long)segs * COORD_SEG;
    const dim3 grid((unsigned)((N + tile - 1) / tile), (unsigned)P);
    bilinear_gather_planes_backward_coords_kernel<G, V><<<grid, segs * group_threads, 0, stream>>>(
        pl, g_a, ga_stride_n, ga_stride_p, groups_a, g_b, gb_stride_n, gb_stride_p, groups,
        group_threads, passes, N, reinterpret_cast<float2*>(coord_grad));
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Adds the gradient of N points into grad (see above). g is float32 (dtype
// 0) or bfloat16 (dtype 1); grad is float32. vec = 4 takes 4-channel loads
// of g (16 bytes in float32, 8 in bfloat16) and float4 atomics and needs C,
// g_stride_n, the channel offset and texel_stride multiples of 4, g aligned
// to a load and grad to 16 bytes; vec = 1 takes any layout. Launches
// on `stream` and returns the cudaError_t of the launch (0 on success). N and
// C must be > 0 and H * W < 2^31.
int ngf_bilinear_gather_2d_backward(const void* g, long long g_stride_n, int C,
                                    const float* coords, long long coord_stride_n,
                                    long long coord_stride_k, float* grad, int H, int W,
                                    long long texel_stride, long long N, int vec, int dtype,
                                    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) {
        const float* gf = static_cast<const float*>(g);
        if (vec == 4 && C % 4 == 0) {
            return launch<float, 4>(gf, g_stride_n, C, coords, coord_stride_n, coord_stride_k,
                                    grad, H, W, texel_stride, N, s);
        }
        if (vec == 1) {
            return launch<float, 1>(gf, g_stride_n, C, coords, coord_stride_n, coord_stride_k,
                                    grad, H, W, texel_stride, N, s);
        }
    } else if (dtype == 1) {
        const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
        if (vec == 4 && C % 4 == 0) {
            return launch<__nv_bfloat16, 4>(gb, g_stride_n, C, coords, coord_stride_n,
                                            coord_stride_k, grad, H, W, texel_stride, N, s);
        }
        if (vec == 1) {
            return launch<__nv_bfloat16, 1>(gb, g_stride_n, C, coords, coord_stride_n,
                                            coord_stride_k, grad, H, W, texel_stride, N, s);
        }
    }
    return (int)cudaErrorInvalidValue;
}

// K2c: adds the plane gradient of a fetch of P planes into their gradients
// and writes the coordinate gradient into coord_grad (N, P, 2), see above.
// desc holds P rows of nine values: the plane's pointer and texel stride,
// its gradient's pointer and texel stride (both pointers offset to the
// fetch's first channel), the coordinates' pointer and two element strides,
// and the plane's H and W. g_a holds channels 0 : c_a of the fetch and g_b
// channels c_a : c_a + c_b (g_b may be null with c_b = 0), each with a point
// and a plane stride. The planes' values and g_a, g_b are float32 (dtype 0)
// or bfloat16 (dtype 1); the gradients and coordinates float32. vec = 4
// takes 4-channel loads (16 bytes in float32, 8 in bfloat16) and float4
// atomics and needs c_a, c_b and every stride but the coordinates' multiples
// of 4, the values' and g's pointers aligned to a load and the gradients' to
// 16 bytes; vec = 1 takes any layout. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success). 1 <= P <= 3, N and c_a > 0,
// every H, W >= 2 and every plane's and gradient's H * W * texel stride <
// 2^31.
int ngf_bilinear_gather_planes_backward_coords(
    const long long* desc, int P, const void* g_a, long long ga_stride_n,
    long long ga_stride_p, int c_a, const void* g_b, long long gb_stride_n,
    long long gb_stride_p, int c_b, long long N, float* coord_grad, int vec, int dtype,
    void* stream) {
    if (P < 1 || P > MAX_PLANES) return (int)cudaErrorInvalidValue;
    CoordPlanes pl = {};
    for (int p = 0; p < P; ++p) {
        const long long* d = desc + 9 * p;
        pl.plane[p] = reinterpret_cast<const void*>(d[0]);
        pl.plane_stride[p] = (int)d[1];
        pl.grad[p] = reinterpret_cast<float*>(d[2]);
        pl.grad_stride[p] = (int)d[3];
        pl.coords[p] = reinterpret_cast<const float*>(d[4]);
        pl.coord_stride_n[p] = d[5];
        pl.coord_stride_k[p] = d[6];
        pl.H[p] = (int)d[7];
        pl.W[p] = (int)d[8];
    }
    cudaStream_t s = (cudaStream_t)stream;
    const bool four = vec == 4 && c_a % 4 == 0 && c_b % 4 == 0;
    if (dtype == 0 && (four || vec == 1)) {
        const float* a = static_cast<const float*>(g_a);
        const float* b = static_cast<const float*>(g_b);
        return four ? launch_coords<float, 4>(pl, P, a, ga_stride_n, ga_stride_p, c_a, b,
                                              gb_stride_n, gb_stride_p, c_b, N, coord_grad, s)
                    : launch_coords<float, 1>(pl, P, a, ga_stride_n, ga_stride_p, c_a, b,
                                              gb_stride_n, gb_stride_p, c_b, N, coord_grad, s);
    }
    if (dtype == 1 && (four || vec == 1)) {
        const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(g_a);
        const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(g_b);
        return four ? launch_coords<__nv_bfloat16, 4>(pl, P, a, ga_stride_n, ga_stride_p, c_a, b,
                                                      gb_stride_n, gb_stride_p, c_b, N,
                                                      coord_grad, s)
                    : launch_coords<__nv_bfloat16, 1>(pl, P, a, ga_stride_n, ga_stride_p, c_a, b,
                                                      gb_stride_n, gb_stride_p, c_b, N,
                                                      coord_grad, s);
    }
    return (int)cudaErrorInvalidValue;
}

// The footprint of K2c's variant of `vec`-channel lanes and element type
// `dtype` (0 float32, 1 bfloat16) on this card: out[0] the blocks of 256
// threads an SM holds at once, out[1] its registers a thread, out[2] its
// local memory a thread in bytes (spills; 0 without). Returns the
// cudaError_t of the queries.
int ngf_bilinear_gather_planes_backward_coords_footprint(int vec, int dtype, int* out) {
    const void* fn;
    if (dtype == 0) {
        fn = vec == 4
            ? reinterpret_cast<const void*>(bilinear_gather_planes_backward_coords_kernel<float, 4>)
            : reinterpret_cast<const void*>(bilinear_gather_planes_backward_coords_kernel<float, 1>);
    } else {
        fn = vec == 4 ? reinterpret_cast<const void*>(
                            bilinear_gather_planes_backward_coords_kernel<__nv_bfloat16, 4>)
                      : reinterpret_cast<const void*>(
                            bilinear_gather_planes_backward_coords_kernel<__nv_bfloat16, 1>);
    }
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
    out[1] = attr.numRegs;
    out[2] = (int)attr.localSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, MAX_THREADS, 0);
}

const char* ngf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
