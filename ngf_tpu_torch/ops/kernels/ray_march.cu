// K5: the NeuTex ray march (compositing scan), forward and backward, for
// Hopper (sm_90a).
//
// Replaces the hand-written XLA op `ray_march` with `simple_tone_map` and the
// background term (ngf_tpu/ops/compositing.py:49,78, wired at
// ngf_tpu/fields/neutex.py:417-423) and its colour-free form `alpha_ray_march`
// (ngf_tpu/ops/compositing.py:83); no Pallas kernel, XLA fuses the cumprod.
// For each ray of S samples:
//
//   sigma_k = density_k * valid_k,  alpha_k = 1 - exp(-sigma_k * dist_k)
//   f_k     = (1 - alpha_k) + 1e-10,    T_0 = 1,  T_{k+1} = T_k * f_k
//   w_k     = alpha_k * T_k,            T_total = T_S
//   colour  = clip((sum_k w_k rgb_k + bg * T_total + 1e-5)^(1/2.2), 0, 1)
//
// Forward writes w (N, S), T_total (N) and, with rgb, the tone-mapped colour
// (N, 3). Backward takes the cotangents of colour, w and T_total (each may
// be absent) and writes d density (N, S) and, with rgb, d rgb (N, S, 3). No
// gradient reaches dist: NeuTex stops the sample positions' gradient
// (ngf_tpu/fields/neutex.py:401).
//
// Backward without division. With c_k = gw_k alpha_k (gw_k the cotangent
// of w_k, colour's share included) and R the cotangent carried from behind,
//   R_{S-1} = gT,  R_{k-1} = c_k + f_k R_k,  dL/dalpha_k = T_k (gw_k - R_k),
// a reverse scan that never divides by f_k: alpha_k rounds to 1 in float32
// once sigma dist >~ 17, f_k is then 1e-10 and the T_k behind it underflow,
// where a cumprod gradient of the form sum(...) / f_k breaks. The backward
// first recomputes T_k in sample order and parks it in its own d density
// row (the same thread overwrites each entry with the gradient in the
// reverse sweep), so nothing is saved between forward and backward but the
// inputs.
//
// Layout. density, valid and dist are (N, S) with a ray stride and a sample
// stride each, read as they lie (valid is bool or uint8, 0 or 1); rgb is
// (N, S, 3) with three strides, read as it lies in the texture MLP's output;
// bg is (N / rays_per_bg, 3) contiguous, ray n taking row n / rays_per_bg.
// Cotangents and outputs are contiguous.
//
// Design. One thread per ray, a sequential scan over its samples: at
// S = 64 the scan is short and the work per ray small. Blocks of 64 rays
// spread the 576 rays of a NeuTex step over 9 SMs. Bound on an H100: memory,
// N * S * 25 bytes forward (density, dist, three rgb channels read, valid,
// w written): 0.92 MB and 0.28 us at 576 x 64, far below a launch, so the
// launch and the scan's latency are what it costs; 105 MB and 31 us at
// 65,536 rays. The threads of a warp read addresses S elements apart, so
// each sample's loads touch a sector per thread; L1 keeps those sectors for
// the next seven samples. A warp per ray with a shuffle scan would read
// coalesced: later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
// 1/2.2 rounded once to float, as the float32 power of the JAX tone map
// takes its Python-float exponent.
constexpr float INV_GAMMA = (float)(1.0 / 2.2);

struct Inputs {
    long long N;
    int S;
    const float* density; long long d_rs, d_ss;
    const unsigned char* valid; long long v_rs, v_ss;
    const float* dist; long long t_rs, t_ss;
    const float* rgb; long long c_rs, c_ss, c_cs;
    const float* bg; long long rays_per_bg;
};

struct Sample {
    float alpha, e, f, dist, valid;
};

__device__ __forceinline__ Sample load_sample(const Inputs& in, long long n, int k) {
    Sample s;
    s.valid = (float)in.valid[n * in.v_rs + k * in.v_ss];
    s.dist = in.dist[n * in.t_rs + k * in.t_ss];
    const float sigma = in.density[n * in.d_rs + k * in.d_ss] * s.valid;
    s.e = expf(-(sigma * s.dist));
    s.alpha = 1.0f - s.e;
    s.f = (1.0f - s.alpha) + 1e-10f;
    return s;
}

__device__ __forceinline__ float rgb_at(const Inputs& in, long long n, int k, int ch) {
    return in.rgb[n * in.c_rs + k * in.c_ss + ch * in.c_cs];
}

__global__ void __launch_bounds__(THREADS) ray_march_forward_kernel(
    Inputs in, float* __restrict__ color, float* __restrict__ weight,
    float* __restrict__ t_total) {
    const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (n >= in.N) return;
    const int S = in.S;
    float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    float* wrow = weight + n * S;
#pragma unroll 4
    for (int k = 0; k < S; ++k) {
        const Sample s = load_sample(in, n, k);
        const float w = s.alpha * T;
        wrow[k] = w;
        if (in.rgb != nullptr) {
            c0 += w * rgb_at(in, n, k, 0);
            c1 += w * rgb_at(in, n, k, 1);
            c2 += w * rgb_at(in, n, k, 2);
        }
        T *= s.f;
    }
    t_total[n] = T;
    if (in.rgb == nullptr) return;
    if (in.bg != nullptr) {
        const float* b = in.bg + (n / in.rays_per_bg) * 3;
        c0 += b[0] * T;
        c1 += b[1] * T;
        c2 += b[2] * T;
    }
    const float c[3] = {c0, c1, c2};
    for (int ch = 0; ch < 3; ++ch) {
        const float y = powf(c[ch] + 1e-5f, INV_GAMMA);
        color[n * 3 + ch] = fminf(fmaxf(y, 0.0f), 1.0f);
    }
}

// d clip(y, 0, 1) / dy as jnp.clip's maximum-then-minimum gives it: half
// the gradient where y meets a bound exactly.
__device__ __forceinline__ float clip_grad(float y) {
    const float lo = y > 0.0f ? 1.0f : (y == 0.0f ? 0.5f : 0.0f);
    const float m = fmaxf(y, 0.0f);
    const float hi = m < 1.0f ? 1.0f : (m == 1.0f ? 0.5f : 0.0f);
    return lo * hi;
}

__global__ void __launch_bounds__(THREADS) ray_march_backward_kernel(
    Inputs in, const float* __restrict__ g_color, const float* __restrict__ g_weight,
    const float* __restrict__ g_t, float* __restrict__ d_density, float* __restrict__ d_rgb) {
    const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (n >= in.N) return;
    const int S = in.S;
    float* drow = d_density + n * S;

    // Sweep 1, in sample order: T_k into this ray's d density row, the
    // linear colour for the tone map's derivative.
    float T = 1.0f, c[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int k = 0; k < S; ++k) {
        const Sample s = load_sample(in, n, k);
        drow[k] = T;
        if (in.rgb != nullptr) {
            const float w = s.alpha * T;
            for (int ch = 0; ch < 3; ++ch) c[ch] += w * rgb_at(in, n, k, ch);
        }
        T *= s.f;
    }

    // Cotangent of the linear colour and of T_total.
    float gc[3] = {0.0f, 0.0f, 0.0f};
    float gT = g_t != nullptr ? g_t[n] : 0.0f;
    if (in.rgb != nullptr && g_color != nullptr) {
        const float* b = in.bg != nullptr ? in.bg + (n / in.rays_per_bg) * 3 : nullptr;
        for (int ch = 0; ch < 3; ++ch) {
            if (b != nullptr) c[ch] += b[ch] * T;
            const float x = c[ch] + 1e-5f;
            const float y = powf(x, INV_GAMMA);
            gc[ch] = g_color[n * 3 + ch] * clip_grad(y) * (INV_GAMMA * powf(x, INV_GAMMA - 1.0f));
            if (b != nullptr) gT += gc[ch] * b[ch];
        }
    }

    // Sweep 2, in reverse: R carries the cotangent from behind sample k.
    float R = gT;
#pragma unroll 4
    for (int k = S - 1; k >= 0; --k) {
        const Sample s = load_sample(in, n, k);
        const float Tk = drow[k];
        float gw = g_weight != nullptr ? g_weight[n * S + k] : 0.0f;
        if (in.rgb != nullptr) {
            float* dr = d_rgb != nullptr ? d_rgb + (n * S + k) * 3 : nullptr;
            const float w = s.alpha * Tk;
            for (int ch = 0; ch < 3; ++ch) {
                gw += gc[ch] * rgb_at(in, n, k, ch);
                if (dr != nullptr) dr[ch] = gc[ch] * w;
            }
        }
        const float d_alpha = Tk * (gw - R);
        R = gw * s.alpha + s.f * R;
        drow[k] = d_alpha * s.e * s.dist * s.valid;
    }
}

unsigned blocks_for(long long N) { return (unsigned)((N + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// rgb null: no colour (color and bg ignored). bg null: no background.
// Returns the cudaError_t of the launch (0 on success). N > 0, S > 0.
int ngf_ray_march_forward(long long N, int S,
                          const float* density, long long d_rs, long long d_ss,
                          const unsigned char* valid, long long v_rs, long long v_ss,
                          const float* dist, long long t_rs, long long t_ss,
                          const float* rgb, long long c_rs, long long c_ss, long long c_cs,
                          const float* bg, long long rays_per_bg,
                          float* color, float* weight, float* t_total, void* stream) {
    const Inputs in{N, S, density, d_rs, d_ss, valid, v_rs, v_ss, dist, t_rs, t_ss,
                    rgb, c_rs, c_ss, c_cs, bg, rays_per_bg};
    ray_march_forward_kernel<<<blocks_for(N), THREADS, 0, (cudaStream_t)stream>>>(
        in, color, weight, t_total);
    return (int)cudaGetLastError();
}

// g_color, g_weight, g_t: contiguous cotangents or null. d_rgb null when
// rgb is null.
int ngf_ray_march_backward(long long N, int S,
                           const float* density, long long d_rs, long long d_ss,
                           const unsigned char* valid, long long v_rs, long long v_ss,
                           const float* dist, long long t_rs, long long t_ss,
                           const float* rgb, long long c_rs, long long c_ss, long long c_cs,
                           const float* bg, long long rays_per_bg,
                           const float* g_color, const float* g_weight, const float* g_t,
                           float* d_density, float* d_rgb, void* stream) {
    const Inputs in{N, S, density, d_rs, d_ss, valid, v_rs, v_ss, dist, t_rs, t_ss,
                    rgb, c_rs, c_ss, c_cs, bg, rays_per_bg};
    ray_march_backward_kernel<<<blocks_for(N), THREADS, 0, (cudaStream_t)stream>>>(
        in, g_color, g_weight, g_t, d_density, d_rgb);
    return (int)cudaGetLastError();
}

const char* ngf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
