// Occupancy lookup (K3) for Hopper (sm_90a): is a point inside occupied
// space of the binary alpha mask?
//
// Replaces the trilinear alpha-mask lookup of the JAX package, a hand-written
// XLA op: `_sample_alpha_volume` (ngf_tpu/render/volume.py:42-54), which runs
// `grid_sample_3d_blocks` on the bf16 parity table of `make_block_table_3d`
// (ngf_tpu/ops/grid_sample.py:507-556) or `grid_sample_3d` (:559-613). Every
// consumer tests the trilinear value `> 0` (render/volume.py:243,249,452,534,
// train/occupancy.py:85-86,100-101), so the kernel returns that test and
// needs no table. The per-point test is `occ::occupied` (occupancy.cuh),
// which the grouped front end (group_compact.cu) shares; it agrees with the
// plain version (`occupancy_lookup_plain`) byte for byte.
//
// Callers. The grouped render path tests its samples inside K4. What stays
// here are point clouds: the mask event's ray filter (51,200 rays x 256
// samples a chunk), its sample counts (16,384 x 886), the dense render with a
// checkpoint's mask (4096 x 884) and the alpha grid with a previous mask. All
// pass contiguous (M, 3) points.
//
// Layout. volume is (D, H, W) uint8, contiguous, z-major (x -> W). out is M
// bytes, 1 = occupied. Two paths:
//   contiguous: points an (M, 3) float32 array, 16-byte aligned. A thread
//     takes four consecutive points: three 16-byte loads and one 4-byte
//     store, 32-bit indices.
//   strided: points an (A, B, 3) view with any element strides (a view such
//     as pts[:, 2::4]), one thread a point; 32-bit index arithmetic where the
//     sizes allow, 64-bit otherwise.
//
// Bound on an H100 SXM: memory. Each point reads 12 bytes and writes one;
// the volume (2 MiB at 128^3, 16 MiB at 256^3) is read from the 50 MB L2
// after its first touch. A filter chunk's 13.1M points move ~170 MB, ~51 us
// at 3.35 TB/s; the ~60 operations a point take ~12 us at 67 TFLOP/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint8_t lookup(float x, float y, float z, bool norm, const occ::Box& box,
                                          const uint8_t* __restrict__ vol, int D, int H, int W) {
    if (norm) {
        x = occ::normalize(x, box.lo[0], box.inv[0]);
        y = occ::normalize(y, box.lo[1], box.inv[1]);
        z = occ::normalize(z, box.lo[2], box.inv[2]);
    }
    return occ::occupied(x, y, z, vol, D, H, W) ? 1 : 0;
}

__device__ __forceinline__ occ::Box box_or_identity(const float* __restrict__ aabb) {
    if (aabb != nullptr) return occ::load_box(aabb);
    return occ::Box{{0.f, 0.f, 0.f}, {1.f, 1.f, 1.f}};
}

__global__ void __launch_bounds__(THREADS) occupancy_lookup_contiguous(
    const float* __restrict__ pts, int M, const float* __restrict__ aabb,
    const uint8_t* __restrict__ vol, int D, int H, int W, uint8_t* __restrict__ out) {
    const int i0 = 4 * (blockIdx.x * THREADS + threadIdx.x);
    if (i0 >= M) return;
    const bool norm = aabb != nullptr;
    const occ::Box box = box_or_identity(aabb);
    if (i0 + 4 <= M) {
        const float4* p = reinterpret_cast<const float4*>(pts + 3 * i0);
        const float4 a = p[0], b = p[1], c = p[2];
        uchar4 r;
        r.x = lookup(a.x, a.y, a.z, norm, box, vol, D, H, W);
        r.y = lookup(a.w, b.x, b.y, norm, box, vol, D, H, W);
        r.z = lookup(b.z, b.w, c.x, norm, box, vol, D, H, W);
        r.w = lookup(c.y, c.z, c.w, norm, box, vol, D, H, W);
        *reinterpret_cast<uchar4*>(out + i0) = r;
    } else {
        for (int i = i0; i < M; ++i) {
            out[i] = lookup(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], norm, box, vol, D, H, W);
        }
    }
}

template <typename I>
__global__ void __launch_bounds__(THREADS) occupancy_lookup_strided(
    const float* __restrict__ pts, I A, I B, I sa, I sb, I sc, const float* __restrict__ aabb,
    const uint8_t* __restrict__ vol, int D, int H, int W, uint8_t* __restrict__ out) {
    const I M = A * B;
    const bool norm = aabb != nullptr;
    const occ::Box box = box_or_identity(aabb);
    for (I i = (I)blockIdx.x * THREADS + threadIdx.x; i < M; i += (I)gridDim.x * THREADS) {
        const I a = i / B;
        const float* p = pts + a * sa + (i - a * B) * sb;
        out[i] = lookup(p[0], p[sc], p[2 * sc], norm, box, vol, D, H, W);
    }
}

}  // namespace

extern "C" {

// points: (A, B, 3) float32 with element strides sa, sb, sc; contiguous != 0
// when they are one contiguous, 16-byte aligned (M, 3) array (then sa, sb, sc
// are not read); aabb: (2, 3) float32 contiguous, or null when the points are
// coordinates in [-1, 1]; volume: (D, H, W) uint8 contiguous with
// D * H * W < 2^31; out: A * B bytes. Strides are >= 0. Launches on `stream`
// and returns the cudaError_t of the launch (0 on success). A * B must be
// > 0, and 3 * A * B below 2^31 on the contiguous path.
int ngf_occupancy_lookup(const float* pts, long long A, long long B, long long sa, long long sb,
                         long long sc, int contiguous, const float* aabb, const uint8_t* vol,
                         int D, int H, int W, uint8_t* out, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const long long M = A * B;
    if (contiguous) {
        const long long blocks = (M + 4LL * THREADS - 1) / (4LL * THREADS);
        occupancy_lookup_contiguous<<<(unsigned)blocks, THREADS, 0, s>>>(pts, (int)M, aabb, vol, D,
                                                                          H, W, out);
        return (int)cudaGetLastError();
    }
    long long blocks = (M + THREADS - 1) / THREADS;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;  // a grid-stride loop covers the rest
    const long long reach = (A - 1) * sa + (B - 1) * sb + 2 * sc + M + blocks * THREADS;
    if (reach < (1LL << 31)) {
        occupancy_lookup_strided<int><<<(unsigned)blocks, THREADS, 0, s>>>(
            pts, (int)A, (int)B, (int)sa, (int)sb, (int)sc, aabb, vol, D, H, W, out);
    } else {
        occupancy_lookup_strided<long long><<<(unsigned)blocks, THREADS, 0, s>>>(
            pts, A, B, sa, sb, sc, aabb, vol, D, H, W, out);
    }
    return (int)cudaGetLastError();
}

const char* ngf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
