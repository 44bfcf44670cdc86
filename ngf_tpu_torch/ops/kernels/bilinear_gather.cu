// Bilinear gather of a channels-last feature plane, for Hopper (sm_90a).
//
// Replaces the TPU kernel `pallas_grid_sample_2d` (ngf_tpu/ops/pallas_kernels.py,
// body `_bilinear_kernel`) and computes exactly `grid_sample_2d`
// (ngf_tpu/ops/grid_sample.py:216-253); the stencil is in bilinear_stencil.cuh.
//
// Layout. The plane is (H, W, C) with texels `texel_stride` elements apart
// and channels contiguous, so a channel slice plane[..., a:b] of a wider
// plane is passed as a pointer offset by `a` with the wide plane's texel
// stride: no copy of the slice. coords are (N, 2) float32 with element
// strides (coord_stride_n, coord_stride_k), so a projection view xyz[..., 0:2]
// needs no copy either. out is (N, C) contiguous, in the plane's type.
//
// Design. One block owns STENCIL_POINTS consecutive points. First one thread
// per point computes its four tap offsets and weights (index and weight math
// in float32) into shared memory. Then all threads walk the block's
// points * C output elements in order: neighbouring threads take neighbouring
// channels of one point, so each tap's C values load coalesced and every
// store is coalesced. Accumulation is in float32 whatever the plane type.
//
// Bound on an H100 SXM: memory. Per point it writes C values and reads 8
// bytes of coords; the plane is read once (a 256 x 256 x 96 float32 plane is
// 25 MB and stays in the 50 MB L2). For the appearance fetch of the
// render path (N = 3,620,864, C = 72, float32) that is about 1.09 GB, i.e.
// about 0.33 ms at 3.35 TB/s, against about 2 GFLOP of arithmetic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "bilinear_stencil.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int POINTS = STENCIL_POINTS;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS) bilinear_gather_2d_kernel(
    const T* __restrict__ plane, int H, int W, long long texel_stride, int C,
    const float* __restrict__ coords, long long coord_stride_n,
    long long coord_stride_k, T* __restrict__ out, long long N) {
    __shared__ long long s_off[4][POINTS];
    __shared__ float s_w[4][POINTS];

    const long long first = (long long)blockIdx.x * POINTS;
    const int npts = (int)min((long long)POINTS, N - first);
    stencil_taps(coords, coord_stride_n, coord_stride_k, H, W, texel_stride, first, npts,
                 s_off, s_w);
    __syncthreads();

    T* dst = out + first * C;
    const int total = npts * C;
    for (int e = threadIdx.x; e < total; e += THREADS) {
        const int p = e / C;
        const int c = e - p * C;
        float acc = s_w[0][p] * to_float(plane[s_off[0][p] + c]);
        acc += s_w[1][p] * to_float(plane[s_off[1][p] + c]);
        acc += s_w[2][p] * to_float(plane[s_off[2][p] + c]);
        acc += s_w[3][p] * to_float(plane[s_off[3][p] + c]);
        store(dst + e, acc);
    }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success). N must be > 0.
int ngf_bilinear_gather_2d(const void* plane, int H, int W, long long texel_stride,
                           int C, const float* coords, long long coord_stride_n,
                           long long coord_stride_k, void* out, long long N,
                           int dtype, void* stream) {
    const long long blocks = (N + POINTS - 1) / POINTS;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) {
        bilinear_gather_2d_kernel<float><<<(unsigned)blocks, THREADS, 0, s>>>(
            (const float*)plane, H, W, texel_stride, C, coords, coord_stride_n,
            coord_stride_k, (float*)out, N);
    } else if (dtype == 1) {
        bilinear_gather_2d_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, s>>>(
            (const __nv_bfloat16*)plane, H, W, texel_stride, C, coords,
            coord_stride_n, coord_stride_k, (__nv_bfloat16*)out, N);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

const char* ngf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
