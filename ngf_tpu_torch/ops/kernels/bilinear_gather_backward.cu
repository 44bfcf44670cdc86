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
// Design. As in the forward: one block owns STENCIL_POINTS consecutive points
// and computes their taps into shared memory; then all threads walk the
// block's points * C gradient values in order, so neighbouring threads read
// neighbouring channels of g and add into neighbouring channels of one tap.
// The adds are float32 atomicAdd with the result unused (RED instructions);
// a warp's adds to one tap are 32 consecutive words, so they coalesce in L2.
// Ray-consecutive points share texels, so atomics on one address contend; no
// pre-reduction is attempted here. Their order varies from run to run, so the
// result is deterministic only up to float32 rounding.
//
// Bound on an H100 SXM: memory. g is read once (N * C * 4 bytes), coords once
// (8 bytes a point), the plane gradient read and written once. For the
// appearance fetch of the training step (N = 4096 * 512 = 2,097,152, C = 72)
// that is about 0.65 GB, about 0.19 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear_stencil.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int POINTS = STENCIL_POINTS;

__global__ void __launch_bounds__(THREADS) bilinear_gather_2d_backward_kernel(
    const float* __restrict__ g, long long g_stride_n, int C,
    const float* __restrict__ coords, long long coord_stride_n,
    long long coord_stride_k, float* __restrict__ grad, int H, int W,
    long long texel_stride, long long N) {
    __shared__ long long s_off[4][POINTS];
    __shared__ float s_w[4][POINTS];

    const long long first = (long long)blockIdx.x * POINTS;
    const int npts = (int)min((long long)POINTS, N - first);
    stencil_taps(coords, coord_stride_n, coord_stride_k, H, W, texel_stride, first, npts,
                 s_off, s_w);
    __syncthreads();

    const int total = npts * C;
    for (int e = threadIdx.x; e < total; e += THREADS) {
        const int p = e / C;
        const int c = e - p * C;
        const float v = g[(first + p) * g_stride_n + c];
        atomicAdd(grad + s_off[0][p] + c, s_w[0][p] * v);
        atomicAdd(grad + s_off[1][p] + c, s_w[1][p] * v);
        atomicAdd(grad + s_off[2][p] + c, s_w[2][p] * v);
        atomicAdd(grad + s_off[3][p] + c, s_w[3][p] * v);
    }
}

}  // namespace

extern "C" {

// Adds the gradient of N points into grad (see above). Launches on `stream`
// and returns the cudaError_t of the launch (0 on success). N must be > 0.
int ngf_bilinear_gather_2d_backward(const float* g, long long g_stride_n, int C,
                                    const float* coords, long long coord_stride_n,
                                    long long coord_stride_k, float* grad, int H, int W,
                                    long long texel_stride, long long N, void* stream) {
    const long long blocks = (N + POINTS - 1) / POINTS;
    bilinear_gather_2d_backward_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        g, g_stride_n, C, coords, coord_stride_n, coord_stride_k, grad, H, W, texel_stride, N);
    return (int)cudaGetLastError();
}

const char* ngf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
