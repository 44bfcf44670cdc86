// Bilinear gather of a channels-last feature plane, for Hopper (sm_90a).
//
// Replaces the TPU kernel `pallas_grid_sample_2d` (ngf_tpu/ops/pallas_kernels.py,
// body `_bilinear_kernel`) and computes exactly `grid_sample_2d`
// (ngf_tpu/ops/grid_sample.py:216-253): torch `F.grid_sample` semantics with
// align_corners=True and zero padding. coords[n, 0] indexes the W axis and
// coords[n, 1] the H axis, both in [-1, 1]. Per axis the 2-texel stencil starts
// at clip(floor(c), 0, size - 2); a stencil slot's weight is the bilinear
// weight its texel has in the *unclipped* stencil, or 0 if it is not part of
// it (`_axis_patch_weights`, grid_sample.py:38-57). That is zero padding
// without any out-of-bounds read.
//
// Layout. The plane is (H, W, C) with texels `texel_stride` elements apart
// and channels contiguous, so a channel slice plane[..., a:b] of a wider
// plane is passed as a pointer offset by `a` with the wide plane's texel
// stride: no copy of the slice. coords are (N, 2) float32 with element
// strides (coord_stride_n, coord_stride_k), so a projection view xyz[..., 0:2]
// needs no copy either. out is (N, C) contiguous, in the plane's type.
//
// Design. One block owns POINTS consecutive points. First POINTS threads each
// compute one point's four tap offsets and weights (index and weight math in
// float32) into shared memory. Then all threads walk the block's POINTS * C
// output elements in order: neighbouring threads take neighbouring channels of
// one point, so each tap's C values load coalesced and every store is
// coalesced. Accumulation is in float32 whatever the plane type.
//
// Bound on an H100 SXM: memory. Per point it writes C values and reads 8
// bytes of coords; the plane is read once (a 256 x 256 x 96 float32 plane is
// 25 MB and stays in the 50 MB L2). For the appearance fetch of the
// render path (N = 3,620,864, C = 72, float32) that is about 1.09 GB, i.e.
// about 0.33 ms at 3.35 TB/s, against about 2 GFLOP of arithmetic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int POINTS = 64;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One axis of the clipped 2-texel stencil (`_axis_patch_weights`).
// c is the raw coordinate in [-1, 1]; returns the stencil start and the two
// slot weights. Values beyond one texel outside the plane are clamped first:
// they get weight 0 either way, and the clamp keeps the float-to-int
// conversion in range.
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

template <typename T>
__global__ void __launch_bounds__(THREADS) bilinear_gather_2d_kernel(
    const T* __restrict__ plane, int H, int W, long long texel_stride, int C,
    const float* __restrict__ coords, long long coord_stride_n,
    long long coord_stride_k, T* __restrict__ out, long long N) {
    __shared__ long long s_off[4][POINTS];
    __shared__ float s_w[4][POINTS];

    const long long first = (long long)blockIdx.x * POINTS;
    const int npts = (int)min((long long)POINTS, N - first);

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
