// K5: the compositing scan along rays, forward and backward, for Hopper
// (sm_90a), in two modes over one warp-scan core.
//
// NeuTex mode replaces the hand-written XLA op `ray_march` with
// `simple_tone_map` and the background term (ngf_tpu/ops/compositing.py:49,78,
// wired at ngf_tpu/fields/neutex.py:417-423) and its colour-free form
// `alpha_ray_march` (ngf_tpu/ops/compositing.py:83). Tri-plane mode replaces
// `raw2alpha` (ngf_tpu/ops/compositing.py:32) with the renderers' composite
// after it (ngf_tpu/render/volume.py:311-358 grouped, :469-505 dense). No
// Pallas kernel: XLA fuses the cumprod. For each ray of S samples:
//
//   alpha_k = 1 - exp(-sigma_k * dist_k),  f_k = (1 - alpha_k) + 1e-10
//   T_0 = 1,  T_{k+1} = T_k * f_k,  w_k = alpha_k * T_k
//
// NeuTex: sigma_k = density_k * valid_k; writes w (N, S), T_total = T_S (N)
// and, with rgb, colour = clip((sum_k w_k rgb_k + bg * T_total + 1e-5)^(1/2.2),
// 0, 1) (N, 3). No gradient reaches dist (ngf_tpu/fields/neutex.py:401).
//
// Tri-plane: sigma is the field's density times the valid mask, dist a
// per-sample length or one constant (the grouped path's); with
// m_k = (w_k > thres), acc = sum_k w_k,
//   y = sum_k w_k m_k rgb_k + b (1 - acc),  rgb_map = clip(y, 0, 1),
//   depth = sum_k w_k z_k + (1 - acc) ray_last   (no gradient),
// b the background (1 white, the batch's 0/1 draw, or 0). Writes rgb_map,
// y (N, 3; the backward's clip derivative reads it), acc, depth (N) and, when
// asked, w (N, S).
//
// Tri-plane top-K mode replaces the top-K shading branches of the same
// renderers (ngf_tpu/render/volume.py:315-338 grouped, :473-487 dense): only
// K selected samples of a ray are shaded, and their colour is known only
// after the weights have chosen them. So it runs as two launches each way:
//   forward:  the tri-plane forward with no rgb writes w, acc and depth; the
//             caller picks the samples by w (torch.topk), fetches and decodes
//             them, then the colour pass computes, with slot k's sample
//             s_k = idx[n, k / G] * G + k % G (G the group, 1 on the dense
//             path) and m_k = (w_{s_k} > thres),
//               y = sum_k m_k w_{s_k} rgb_k + b (1 - acc),  rgb_map = clip(y, 0, 1);
//   backward: the colour pass's backward writes the dense cotangent of w
//             (N, S): m_k gy . rgb_k at the selected samples, 0 elsewhere;
//             d rgb_k = gy m_k w_{s_k}, and d acc = -b sum(gy); then the
//             tri-plane backward with no rgb takes that g_w beside g_acc
//             into its reverse scan.
// (The JAX package also multiplies m_k by the valid mask; an invalid sample
// has sigma 0, so w 0, which does not clear the threshold.)
//
// Tri-plane shard mode replaces the per-shard composite of the
// sample-parallel renderer (ngf_tpu/parallel/sample_parallel.py:99-130): a
// ray's samples are split over shards, and a shard starts its scan at t0, the
// product of the earlier shards' totals, which it learns only after an
// exchange. So it runs as two launches forward:
//   totals:    t_end = prod_k f_k over the shard (JAX's `local_total`),
//   composite: w_k = (alpha_k T_k) t0 in JAX's order, m_k = (w_k > thres),
//              the partial sums y = sum_k m_k w_k rgb_k, acc = sum_k w_k,
//              depth = sum_k w_k z_k (no background, no clip, no depth fill:
//              the renderer adds them after the sums are reduced over the
//              shards), and the local sums sum_k m_k alpha_k T_k rgb_k and
//              sum_k alpha_k T_k (N, 4), from which dL/dt0 = g_acc . acc_loc +
//              g_y . y_loc needs no pass over the samples;
// and one launch backward: from the cotangents of y, acc and t_end, d sigma
// and d rgb by the reverse scan below with gw_k scaled by t0 and R_{S-1} =
// g_tend (the t_end term folded in without dividing by t0 or f: a shard behind
// opaque samples has t0 = 0), and dL/dt0 = sum_k gw_k alpha_k T_k.
//
// Backward without division. With gw_k the cotangent of w_k (every output's
// share through w: colour, acc, w itself) and R the cotangent carried from
// behind,
//   R_{S-1} = g_T,  R_{k-1} = gw_k alpha_k + f_k R_k,  dL/dalpha_k = T_k (gw_k - R_k),
// a reverse scan that never divides by f_k: alpha_k rounds to 1 in float32
// once sigma dist >~ 17, f_k is then 1e-10 and the T_k behind it underflow,
// where a cumprod gradient of the form sum(...) / f_k breaks. The clip passes
// half the gradient where y meets a bound exactly, as jnp.clip does.
//
// Design: a warp a ray, in tiles of 32 samples. Lane j of tile t holds sample
// 32t + j, so the loads of density, dist, z, valid and rgb are coalesced.
// - T: an inclusive product scan of f over the tile by __shfl_up_sync (five
//   steps); its exclusive form is the scan shifted by one lane (no
//   division); times the carry, which lane 31's product then advances.
// - Forward sums: each lane keeps partial sums (w m rgb, w, w z), reduced
//   once at the ray's end by __shfl_xor_sync.
// - Backward: a first pass keeps each tile's starting T in shared memory (S/32
//   floats a warp; reading only sigma and dist in tri-plane mode, whose y comes
//   from the forward). The reverse pass rescans each tile from its starting T
//   while its data is still in L1/L2, and runs the recurrence above as a
//   suffix scan of the affine maps R -> c + f R over the tile by
//   __shfl_down_sync, with the carry from the tile behind.
// - The threshold mask is the forward's bit for bit: the backward recomputes w
//   by the same code on the same inputs (the scan and the carry in
//   round-to-nearest intrinsics, which the compiler neither contracts nor
//   reorders), and reads the forward's y for the clip. The NeuTex backward
//   recomputes its linear colour the same way.
// - Eight warps a block: 72 blocks for a UV step's 576 rays, 512 for a
//   4096-ray train batch.
// Bound on an H100: memory. Tri-plane forward per sample: sigma, dist, z (4
// bytes each; a constant dist 0) and rgb (12) read, w (4) written when asked;
// backward: sigma, dist, rgb read, d sigma (4) and d rgb (12) written. NeuTex
// adds valid (1) and, backward, the cotangent of w (4); so does the top-K
// mode's weight backward. The colour pass reads w at the selected samples
// (4 a slot), the group ids (8 a group) and rgb_k (12 a slot); its backward
// writes the whole g_w row (4 a sample) and d rgb_k (12 a slot).
// The colour pass runs a warp a ray too, a lane a slot, tiles of 32 slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
// 1/2.2 rounded once to float, as the float32 power of the JAX tone map
// takes its Python-float exponent.
constexpr float INV_GAMMA = (float)(1.0 / 2.2);

struct Args {
    long long N;
    int S;
    const float* sigma; long long s_rs, s_ss;
    const unsigned char* valid; long long v_rs, v_ss;  // NeuTex; null in tri-plane
    const float* dist; long long t_rs, t_ss;          // null: every sample dist_const
    float dist_const;
    const float* rgb; long long c_rs, c_ss, c_cs;     // null: no colour (NeuTex)
    // NeuTex
    const float* bg; long long rays_per_bg;          // (N / rays_per_bg, 3) or null
    // Tri-plane
    const float* z; long long z_rs, z_ss;
    const float* ray_last; long long r_rs;
    const float* bg_ptr; float bg_const;              // b: *bg_ptr, or bg_const without it
    float thres;
    const float* t0;                                  // shard mode: (N) starting transmittance
};

// One sample's loaded values; a lane past the ray's end holds zeros, so
// alpha 0 and f 1: it adds nothing and leaves T as it is.
struct Loaded {
    float sigma = 0.0f, dist = 0.0f, valid = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f, z = 0.0f;
};

template <bool TRI>
__device__ __forceinline__ Loaded load(const Args& a, long long n, int k, bool colour, bool depth) {
    Loaded s;
    if (k >= a.S) return s;
    s.sigma = a.sigma[n * a.s_rs + k * a.s_ss];
    if (!TRI) {
        s.valid = (float)a.valid[n * a.v_rs + k * a.v_ss];
        s.sigma = __fmul_rn(s.sigma, s.valid);
    }
    s.dist = a.dist != nullptr ? a.dist[n * a.t_rs + k * a.t_ss] : a.dist_const;
    if (colour) {
        const float* c = a.rgb + n * a.c_rs + k * a.c_ss;
        s.r = c[0];
        s.g = c[a.c_cs];
        s.b = c[2 * a.c_cs];
    }
    if (depth) s.z = a.z[n * a.z_rs + k * a.z_ss];
    return s;
}

struct Alpha {
    float e, alpha, f;
};

__device__ __forceinline__ Alpha alpha_of(const Loaded& s) {
    Alpha o;
    o.e = expf(-__fmul_rn(s.sigma, s.dist));
    o.alpha = __fsub_rn(1.0f, o.e);
    o.f = __fadd_rn(__fsub_rn(1.0f, o.alpha), 1e-10f);
    return o;
}

// T of this lane's sample: the carry (T at the tile's first sample) times the
// exclusive product of f over the lanes before it. Advances the carry past
// the tile.
__device__ __forceinline__ float tile_transmittance(float f, float& carry, int lane) {
    float p = f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const float q = __shfl_up_sync(FULL, p, d);
        if (lane >= d) p = __fmul_rn(q, p);
    }
    float before = __shfl_up_sync(FULL, p, 1);
    if (lane == 0) before = 1.0f;
    const float T = __fmul_rn(carry, before);
    carry = __fmul_rn(carry, __shfl_sync(FULL, p, 31));
    return T;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, d));
    return v;
}

// A ray's forward sums, the same in every lane.
struct Sums {
    float c[3] = {0.0f, 0.0f, 0.0f};
    float acc = 0.0f, wz = 0.0f, t_total = 1.0f;
    float loc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // shard mode: sum m alpha T rgb, sum alpha T
};

// The forward sweep over one ray, tile by tile, shared by the forward kernels
// and the backward's first pass so that both compute every w, mask and sum
// alike. Writes w when `weight` is given and each tile's starting T when
// `tstart` is; sums the colour when `colour`, and (tri-plane) the depth when
// `depth`. SHARD: w is alpha T times the ray's t0, and the local sums are
// kept beside the others.
template <bool TRI, bool SHARD = false>
__device__ Sums sweep(const Args& a, long long n, int lane, bool colour, bool depth,
                      float* __restrict__ weight, float* __restrict__ tstart) {
    const int tiles = (a.S + 31) / 32;
    const float t0 = SHARD ? a.t0[n] : 1.0f;
    float carry = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, acc = 0.0f, wz = 0.0f;
    float l0 = 0.0f, l1 = 0.0f, l2 = 0.0f, lacc = 0.0f;
    Loaded cur = load<TRI>(a, n, lane, colour, depth);
    for (int t = 0; t < tiles; ++t) {
        const int k = 32 * t + lane;
        Loaded nxt;
        if (t + 1 < tiles) nxt = load<TRI>(a, n, k + 32, colour, depth);
        const Alpha s = alpha_of(cur);
        if (tstart != nullptr && lane == 0) tstart[t] = carry;
        const float T = tile_transmittance(s.f, carry, lane);
        const float wl = __fmul_rn(s.alpha, T);
        const float w = SHARD ? __fmul_rn(wl, t0) : wl;
        if (weight != nullptr && k < a.S) weight[n * a.S + k] = w;
        if (colour && (!TRI || w > a.thres)) {
            c0 = __fmaf_rn(w, cur.r, c0);
            c1 = __fmaf_rn(w, cur.g, c1);
            c2 = __fmaf_rn(w, cur.b, c2);
            if (SHARD) {
                l0 = __fmaf_rn(wl, cur.r, l0);
                l1 = __fmaf_rn(wl, cur.g, l1);
                l2 = __fmaf_rn(wl, cur.b, l2);
            }
        }
        if (TRI) acc = __fadd_rn(acc, w);
        if (SHARD) lacc = __fadd_rn(lacc, wl);
        if (depth) wz = __fmaf_rn(w, cur.z, wz);
        cur = nxt;
    }
    Sums out;
    out.t_total = carry;
    if (colour) {
        out.c[0] = warp_sum(c0);
        out.c[1] = warp_sum(c1);
        out.c[2] = warp_sum(c2);
    }
    if (TRI) out.acc = warp_sum(acc);
    if (depth) out.wz = warp_sum(wz);
    if (SHARD) {
        out.loc[0] = warp_sum(l0);
        out.loc[1] = warp_sum(l1);
        out.loc[2] = warp_sum(l2);
        out.loc[3] = warp_sum(lacc);
    }
    return out;
}

// d clip(y, 0, 1) / dy as jnp.clip's maximum-then-minimum gives it: half
// the gradient where y meets a bound exactly.
__device__ __forceinline__ float clip_grad(float y) {
    const float lo = y > 0.0f ? 1.0f : (y == 0.0f ? 0.5f : 0.0f);
    const float m = fmaxf(y, 0.0f);
    const float hi = m < 1.0f ? 1.0f : (m == 1.0f ? 0.5f : 0.0f);
    return lo * hi;
}

// clip(y, 0, 1) that keeps a NaN, as jnp.clip does.
__device__ __forceinline__ float clip01(float y) {
    return y < 0.0f ? 0.0f : (y > 1.0f ? 1.0f : y);
}

__device__ __forceinline__ float background(const Args& a) {
    return a.bg_ptr != nullptr ? *a.bg_ptr : a.bg_const;
}

// ---------------------------------------------------------------- forward

__global__ void __launch_bounds__(THREADS) ray_march_neutex_forward_kernel(
    Args a, float* __restrict__ color, float* __restrict__ weight, float* __restrict__ t_total) {
    const long long n = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (n >= a.N) return;
    const bool colour = a.rgb != nullptr;
    const Sums s = sweep<false>(a, n, lane, colour, false, weight, nullptr);
    if (lane == 0) t_total[n] = s.t_total;
    if (!colour || lane >= 3) return;
    float c = lane == 0 ? s.c[0] : (lane == 1 ? s.c[1] : s.c[2]);
    if (a.bg != nullptr)
        c = __fadd_rn(c, __fmul_rn(a.bg[(n / a.rays_per_bg) * 3 + lane], s.t_total));
    const float y = powf(__fadd_rn(c, 1e-5f), INV_GAMMA);
    color[n * 3 + lane] = fminf(fmaxf(y, 0.0f), 1.0f);
}

// SHARD: rgb_lin takes the partial y, acc and depth the partial sums, `local`
// (N, 4) the local sums; rgb_map is not written.
template <bool SHARD>
__global__ void __launch_bounds__(THREADS) ray_march_triplane_forward_kernel(
    Args a, float* __restrict__ rgb_map, float* __restrict__ rgb_lin, float* __restrict__ acc,
    float* __restrict__ depth, float* __restrict__ weight, float* __restrict__ local) {
    const long long n = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (n >= a.N) return;
    const bool colour = a.rgb != nullptr;  // no colour: top-K mode's weight launch
    const Sums s = sweep<true, SHARD>(a, n, lane, colour, true, weight, nullptr);
    if (SHARD) {
        if (lane < 3) {
            rgb_lin[n * 3 + lane] = lane == 0 ? s.c[0] : (lane == 1 ? s.c[1] : s.c[2]);
            local[n * 4 + lane] = lane == 0 ? s.loc[0] : (lane == 1 ? s.loc[1] : s.loc[2]);
        } else if (lane == 3) {
            acc[n] = s.acc;
            depth[n] = s.wz;
            local[n * 4 + 3] = s.loc[3];
        }
        return;
    }
    const float miss = __fsub_rn(1.0f, s.acc);
    if (lane < 3) {
        if (!colour) return;
        const float c = lane == 0 ? s.c[0] : (lane == 1 ? s.c[1] : s.c[2]);
        const float y = __fadd_rn(c, __fmul_rn(background(a), miss));
        rgb_lin[n * 3 + lane] = y;
        rgb_map[n * 3 + lane] = clip01(y);
    } else if (lane == 3) {
        acc[n] = s.acc;
        depth[n] = __fadd_rn(s.wz, __fmul_rn(miss, a.ray_last[n * a.r_rs]));
    }
}

// Shard mode's totals: t_end = prod_k f_k over the shard, from sigma and dist
// alone, by the forward's scan.
__global__ void __launch_bounds__(THREADS) ray_march_triplane_totals_kernel(
    Args a, float* __restrict__ t_end) {
    const long long n = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (n >= a.N) return;
    const Sums s = sweep<true>(a, n, lane, false, false, nullptr, nullptr);
    if (lane == 0) t_end[n] = s.t_total;
}

// --------------------------------------------------------------- backward

// The reverse pass over one ray. gc: the cotangent of the masked colour sum;
// g_acc: the cotangent every w takes through acc (tri-plane); g_weight: the
// cotangent of w (NeuTex, or null); R: the carry from behind the last sample.
// SHARD: w and the cotangent of alpha T are scaled by the ray's t0, and
// d_t0 (N) takes sum_k gw_k alpha_k T_k.
template <bool TRI, bool SHARD = false>
__device__ void reverse_pass(const Args& a, long long n, int lane, const float* tstart,
                             const float gc[3], float g_acc, const float* __restrict__ g_weight,
                             float R, float* __restrict__ d_sigma, float* __restrict__ d_rgb,
                             float* __restrict__ d_t0 = nullptr) {
    const int tiles = (a.S + 31) / 32;
    const bool colour = a.rgb != nullptr;
    const float t0 = SHARD ? a.t0[n] : 1.0f;
    float gt0 = 0.0f;
    Loaded cur = load<TRI>(a, n, 32 * (tiles - 1) + lane, colour, false);
    for (int t = tiles - 1; t >= 0; --t) {
        const int k = 32 * t + lane;
        Loaded nxt;
        if (t > 0) nxt = load<TRI>(a, n, k - 32, colour, false);
        const Alpha s = alpha_of(cur);
        float carry = tstart[t];
        const float T = tile_transmittance(s.f, carry, lane);
        const float wl = __fmul_rn(s.alpha, T);
        const float w = SHARD ? __fmul_rn(wl, t0) : wl;
        const bool shaded = colour && (!TRI || w > a.thres);
        float gw = g_acc;
        if (g_weight != nullptr && k < a.S) gw += g_weight[n * a.S + k];
        if (shaded) gw += gc[0] * cur.r + gc[1] * cur.g + gc[2] * cur.b;
        if (SHARD) {
            gt0 += gw * wl;
            gw *= t0;  // the cotangent of alpha_k T_k
        }
        // Suffix scan of the maps R -> c + f R over lanes lane..31.
        float cm = gw * s.alpha, fm = s.f;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const float cb = __shfl_down_sync(FULL, cm, d);
            const float fb = __shfl_down_sync(FULL, fm, d);
            if (lane + d < 32) {
                cm = cm + fm * cb;
                fm = fm * fb;
            }
        }
        const float before = cm + fm * R;  // R at the sample ahead of this lane's
        float r_k = __shfl_down_sync(FULL, before, 1);
        if (lane == 31) r_k = R;
        R = __shfl_sync(FULL, before, 0);
        if (k < a.S) {
            // NeuTex: d sigma / d density is valid.
            d_sigma[n * a.S + k] = T * (gw - r_k) * s.e * cur.dist * cur.valid;
            if (d_rgb != nullptr) {
                float* dr = d_rgb + (n * a.S + k) * 3;
                const float ws = shaded ? w : 0.0f;
                dr[0] = gc[0] * ws;
                dr[1] = gc[1] * ws;
                dr[2] = gc[2] * ws;
            }
        }
        cur = nxt;
    }
    if (SHARD) {
        gt0 = warp_sum(gt0);
        if (lane == 0) d_t0[n] = gt0;
    }
}

__global__ void __launch_bounds__(THREADS) ray_march_neutex_backward_kernel(
    Args a, const float* __restrict__ g_color, const float* __restrict__ g_weight,
    const float* __restrict__ g_t, float* __restrict__ d_density, float* __restrict__ d_rgb) {
    extern __shared__ float tstarts[];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long n = (long long)blockIdx.x * WARPS + warp;
    if (n >= a.N) return;
    float* tstart = tstarts + warp * ((a.S + 31) / 32);
    const bool colour = a.rgb != nullptr;
    // The forward's sums again, bit for bit, and each tile's starting T.
    const Sums s = sweep<false>(a, n, lane, colour && g_color != nullptr, false, nullptr, tstart);
    __syncwarp();
    float gT = g_t != nullptr ? g_t[n] : 0.0f;
    float gc[3] = {0.0f, 0.0f, 0.0f};
    if (colour && g_color != nullptr) {
        const float* b = a.bg != nullptr ? a.bg + (n / a.rays_per_bg) * 3 : nullptr;
        for (int ch = 0; ch < 3; ++ch) {
            float c = s.c[ch];
            if (b != nullptr) c = __fadd_rn(c, __fmul_rn(b[ch], s.t_total));
            const float x = __fadd_rn(c, 1e-5f);
            const float y = powf(x, INV_GAMMA);
            gc[ch] = g_color[n * 3 + ch] * clip_grad(y) * (INV_GAMMA * powf(x, INV_GAMMA - 1.0f));
            if (b != nullptr) gT += gc[ch] * b[ch];
        }
    }
    reverse_pass<false>(a, n, lane, tstart, gc, 0.0f, g_weight, gT, d_density, d_rgb);
}

// SHARD: g_rgb is the cotangent of the partial y itself (no clip, no
// background), g_tend that of t_end (or null), and d_t0 is written.
// g_weight: the cotangent of w (N, S) (top-K mode, rgb null), or null.
template <bool SHARD>
__global__ void __launch_bounds__(THREADS) ray_march_triplane_backward_kernel(
    Args a, const float* __restrict__ rgb_lin, const float* __restrict__ g_rgb,
    const float* __restrict__ g_acc, const float* __restrict__ g_tend,
    const float* __restrict__ g_weight,
    float* __restrict__ d_sigma, float* __restrict__ d_rgb, float* __restrict__ d_t0) {
    extern __shared__ float tstarts[];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long n = (long long)blockIdx.x * WARPS + warp;
    if (n >= a.N) return;
    float* tstart = tstarts + warp * ((a.S + 31) / 32);
    // Only each tile's starting T: sigma and dist, the carry as the forward's.
    sweep<true>(a, n, lane, false, false, nullptr, tstart);
    __syncwarp();
    float gc[3] = {0.0f, 0.0f, 0.0f};
    float ga = g_acc != nullptr ? g_acc[n] : 0.0f, R = 0.0f;
    if (SHARD) {
        if (g_rgb != nullptr)
            for (int ch = 0; ch < 3; ++ch) gc[ch] = g_rgb[n * 3 + ch];
        if (g_tend != nullptr) R = g_tend[n];
    } else {
        if (g_rgb != nullptr)
            for (int ch = 0; ch < 3; ++ch) gc[ch] = g_rgb[n * 3 + ch] * clip_grad(rgb_lin[n * 3 + ch]);
        // y = C + b (1 - acc): every w takes -b sum(gc) through acc.
        ga -= background(a) * (gc[0] + gc[1] + gc[2]);
    }
    reverse_pass<true, SHARD>(a, n, lane, tstart, gc, ga, g_weight, R, d_sigma, d_rgb, d_t0);
}

// ------------------------------------------------------- top-K colour pass

struct TopK {
    long long N;
    int S, K, G;                                     // K slots = (ids a ray) * G
    const float* w;                                  // (N, S) contiguous
    const long long* idx; long long i_rs, i_cs;      // (N, K / G) group ids
    const float* rgb; long long c_rs, c_ss, c_cs;    // (N, K, 3)
    const float* acc;                                // (N) contiguous
    const float* bg_ptr; float bg_const;
    float thres;
};

// The selected sample of slot k of ray n (k < K).
__device__ __forceinline__ long long topk_sample(const TopK& t, long long n, int k) {
    return t.idx[n * t.i_rs + (k / t.G) * t.i_cs] * t.G + k % t.G;
}

__device__ __forceinline__ float topk_background(const TopK& t) {
    return t.bg_ptr != nullptr ? *t.bg_ptr : t.bg_const;
}

__global__ void __launch_bounds__(THREADS) ray_march_topk_forward_kernel(
    TopK t, float* __restrict__ rgb_map, float* __restrict__ rgb_lin) {
    const long long n = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (n >= t.N) return;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    for (int k = lane; k < t.K; k += 32) {
        const float w = t.w[n * t.S + topk_sample(t, n, k)];
        if (w > t.thres) {
            const float* c = t.rgb + n * t.c_rs + k * t.c_ss;
            c0 = __fmaf_rn(w, c[0], c0);
            c1 = __fmaf_rn(w, c[t.c_cs], c1);
            c2 = __fmaf_rn(w, c[2 * t.c_cs], c2);
        }
    }
    c0 = warp_sum(c0);
    c1 = warp_sum(c1);
    c2 = warp_sum(c2);
    if (lane < 3) {
        const float c = lane == 0 ? c0 : (lane == 1 ? c1 : c2);
        const float y = __fadd_rn(c, __fmul_rn(topk_background(t), __fsub_rn(1.0f, t.acc[n])));
        rgb_lin[n * 3 + lane] = y;
        rgb_map[n * 3 + lane] = clip01(y);
    }
}

// g_w (N, S): the whole row written (zeros, then the selected samples, which
// are distinct); d_acc (N); d_rgb (N, K, 3) contiguous.
__global__ void __launch_bounds__(THREADS) ray_march_topk_backward_kernel(
    TopK t, const float* __restrict__ rgb_lin, const float* __restrict__ g_rgb,
    float* __restrict__ g_w, float* __restrict__ d_acc, float* __restrict__ d_rgb) {
    const long long n = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (n >= t.N) return;
    float gc[3];
    for (int ch = 0; ch < 3; ++ch) gc[ch] = g_rgb[n * 3 + ch] * clip_grad(rgb_lin[n * 3 + ch]);
    if (lane == 0) d_acc[n] = -topk_background(t) * (gc[0] + gc[1] + gc[2]);
    float* row = g_w + n * t.S;
    for (int k = lane; k < t.S; k += 32) row[k] = 0.0f;
    __syncwarp();  // orders the zeros before the selected samples' writes
    for (int k = lane; k < t.K; k += 32) {
        const long long s = topk_sample(t, n, k);
        const float w = t.w[n * t.S + s];
        const float* c = t.rgb + n * t.c_rs + k * t.c_ss;
        const bool shaded = w > t.thres;
        row[s] = shaded ? gc[0] * c[0] + gc[1] * c[t.c_cs] + gc[2] * c[2 * t.c_cs] : 0.0f;
        const float ws = shaded ? w : 0.0f;
        float* dr = d_rgb + (n * t.K + k) * 3;
        dr[0] = gc[0] * ws;
        dr[1] = gc[1] * ws;
        dr[2] = gc[2] * ws;
    }
}

unsigned blocks_for(long long N) { return (unsigned)((N + WARPS - 1) / WARPS); }
size_t tstart_bytes(int S) { return (size_t)WARPS * ((S + 31) / 32) * sizeof(float); }

Args neutex_args(long long N, int S, const float* density, long long d_rs, long long d_ss,
                 const unsigned char* valid, long long v_rs, long long v_ss,
                 const float* dist, long long t_rs, long long t_ss,
                 const float* rgb, long long c_rs, long long c_ss, long long c_cs,
                 const float* bg, long long rays_per_bg) {
    Args a{};
    a.N = N; a.S = S;
    a.sigma = density; a.s_rs = d_rs; a.s_ss = d_ss;
    a.valid = valid; a.v_rs = v_rs; a.v_ss = v_ss;
    a.dist = dist; a.t_rs = t_rs; a.t_ss = t_ss;
    a.rgb = rgb; a.c_rs = c_rs; a.c_ss = c_ss; a.c_cs = c_cs;
    a.bg = bg; a.rays_per_bg = rays_per_bg;
    return a;
}

Args triplane_args(long long N, int S, const float* sigma, long long s_rs, long long s_ss,
                   const float* dist, long long t_rs, long long t_ss, float dist_const,
                   const float* rgb, long long c_rs, long long c_ss, long long c_cs,
                   const float* bg, float bg_const, float thres) {
    Args a{};
    a.N = N; a.S = S;
    a.sigma = sigma; a.s_rs = s_rs; a.s_ss = s_ss;
    a.dist = dist; a.t_rs = t_rs; a.t_ss = t_ss; a.dist_const = dist_const;
    a.rgb = rgb; a.c_rs = c_rs; a.c_ss = c_ss; a.c_cs = c_cs;
    a.bg_ptr = bg; a.bg_const = bg_const; a.thres = thres;
    return a;
}

TopK topk_args(long long N, int S, int K, int G, const float* w,
               const long long* idx, long long i_rs, long long i_cs,
               const float* rgb, long long c_rs, long long c_ss, long long c_cs,
               const float* acc, const float* bg, float bg_const, float thres) {
    TopK t{};
    t.N = N; t.S = S; t.K = K; t.G = G; t.w = w;
    t.idx = idx; t.i_rs = i_rs; t.i_cs = i_cs;
    t.rgb = rgb; t.c_rs = c_rs; t.c_ss = c_ss; t.c_cs = c_cs;
    t.acc = acc; t.bg_ptr = bg; t.bg_const = bg_const; t.thres = thres;
    return t;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). N > 0, 0 < S <=
// ngf_ray_march_max_samples().

int ngf_ray_march_max_samples() { return (int)(48 * 1024 / (WARPS * sizeof(float))) * 32; }

// NeuTex. rgb null: no colour (color and bg ignored). bg null: no background.
int ngf_ray_march_forward(long long N, int S,
                          const float* density, long long d_rs, long long d_ss,
                          const unsigned char* valid, long long v_rs, long long v_ss,
                          const float* dist, long long t_rs, long long t_ss,
                          const float* rgb, long long c_rs, long long c_ss, long long c_cs,
                          const float* bg, long long rays_per_bg,
                          float* color, float* weight, float* t_total, void* stream) {
    const Args a = neutex_args(N, S, density, d_rs, d_ss, valid, v_rs, v_ss, dist, t_rs, t_ss,
                               rgb, c_rs, c_ss, c_cs, bg, rays_per_bg);
    ray_march_neutex_forward_kernel<<<blocks_for(N), THREADS, 0, (cudaStream_t)stream>>>(
        a, color, weight, t_total);
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
    const Args a = neutex_args(N, S, density, d_rs, d_ss, valid, v_rs, v_ss, dist, t_rs, t_ss,
                               rgb, c_rs, c_ss, c_cs, bg, rays_per_bg);
    ray_march_neutex_backward_kernel<<<blocks_for(N), THREADS, tstart_bytes(S),
                                       (cudaStream_t)stream>>>(
        a, g_color, g_weight, g_t, d_density, d_rgb);
    return (int)cudaGetLastError();
}

// Tri-plane. dist null: every sample's length is dist_const. bg null: the
// background is bg_const. ray_last: rays[:, -1] with ray stride r_rs.
// weight null: w is not written. rgb null (top-K mode's weight launch): no
// colour; rgb_map and rgb_lin are not written and may be null.
int ngf_ray_march_triplane_forward(long long N, int S,
                                   const float* sigma, long long s_rs, long long s_ss,
                                   const float* dist, long long t_rs, long long t_ss,
                                   float dist_const,
                                   const float* rgb, long long c_rs, long long c_ss, long long c_cs,
                                   const float* z, long long z_rs, long long z_ss,
                                   const float* ray_last, long long r_rs,
                                   const float* bg, float bg_const, float thres,
                                   float* rgb_map, float* rgb_lin, float* acc, float* depth,
                                   float* weight, void* stream) {
    Args a = triplane_args(N, S, sigma, s_rs, s_ss, dist, t_rs, t_ss, dist_const,
                           rgb, c_rs, c_ss, c_cs, bg, bg_const, thres);
    a.z = z; a.z_rs = z_rs; a.z_ss = z_ss;
    a.ray_last = ray_last; a.r_rs = r_rs;
    ray_march_triplane_forward_kernel<false><<<blocks_for(N), THREADS, 0, (cudaStream_t)stream>>>(
        a, rgb_map, rgb_lin, acc, depth, weight, nullptr);
    return (int)cudaGetLastError();
}

// rgb_lin: the forward's y (N, 3). g_rgb (N, 3), g_acc (N), g_weight (N, S):
// contiguous or null. rgb null (top-K mode's weight backward): d_rgb null.
int ngf_ray_march_triplane_backward(long long N, int S,
                                    const float* sigma, long long s_rs, long long s_ss,
                                    const float* dist, long long t_rs, long long t_ss,
                                    float dist_const,
                                    const float* rgb, long long c_rs, long long c_ss, long long c_cs,
                                    const float* bg, float bg_const, float thres,
                                    const float* rgb_lin, const float* g_rgb, const float* g_acc,
                                    const float* g_weight, float* d_sigma, float* d_rgb,
                                    void* stream) {
    const Args a = triplane_args(N, S, sigma, s_rs, s_ss, dist, t_rs, t_ss, dist_const,
                                 rgb, c_rs, c_ss, c_cs, bg, bg_const, thres);
    ray_march_triplane_backward_kernel<false><<<blocks_for(N), THREADS, tstart_bytes(S),
                                                (cudaStream_t)stream>>>(
        a, rgb_lin, g_rgb, g_acc, nullptr, g_weight, d_sigma, d_rgb, nullptr);
    return (int)cudaGetLastError();
}

// Top-K colour pass. w (N, S), acc (N) contiguous; idx (N, K / G) int64 group
// ids (sample ids when G = 1); rgb (N, K, 3) any strides; bg null: the
// background is bg_const. Writes rgb_map and rgb_lin (N, 3).
int ngf_ray_march_topk_forward(long long N, int S, int K, int G, const float* w,
                               const long long* idx, long long i_rs, long long i_cs,
                               const float* rgb, long long c_rs, long long c_ss, long long c_cs,
                               const float* acc, const float* bg, float bg_const, float thres,
                               float* rgb_map, float* rgb_lin, void* stream) {
    const TopK t = topk_args(N, S, K, G, w, idx, i_rs, i_cs, rgb, c_rs, c_ss, c_cs, acc, bg,
                             bg_const, thres);
    ray_march_topk_forward_kernel<<<blocks_for(N), THREADS, 0, (cudaStream_t)stream>>>(
        t, rgb_map, rgb_lin);
    return (int)cudaGetLastError();
}

// Its backward: rgb_lin (the forward's y) and g_rgb (N, 3) contiguous; writes
// g_w (N, S), d_acc (N) and d_rgb (N, K, 3), contiguous. acc is not read.
int ngf_ray_march_topk_backward(long long N, int S, int K, int G, const float* w,
                                const long long* idx, long long i_rs, long long i_cs,
                                const float* rgb, long long c_rs, long long c_ss, long long c_cs,
                                const float* bg, float bg_const, float thres,
                                const float* rgb_lin, const float* g_rgb,
                                float* g_w, float* d_acc, float* d_rgb, void* stream) {
    const TopK t = topk_args(N, S, K, G, w, idx, i_rs, i_cs, rgb, c_rs, c_ss, c_cs, nullptr, bg,
                             bg_const, thres);
    ray_march_topk_backward_kernel<<<blocks_for(N), THREADS, 0, (cudaStream_t)stream>>>(
        t, rgb_lin, g_rgb, g_w, d_acc, d_rgb);
    return (int)cudaGetLastError();
}

// Tri-plane shard mode. dist null: every sample's length is dist_const.
// totals: t_end (N).
int ngf_ray_march_triplane_totals(long long N, int S,
                                  const float* sigma, long long s_rs, long long s_ss,
                                  const float* dist, long long t_rs, long long t_ss,
                                  float dist_const, float* t_end, void* stream) {
    const Args a = triplane_args(N, S, sigma, s_rs, s_ss, dist, t_rs, t_ss, dist_const,
                                 nullptr, 0, 0, 0, nullptr, 0.0f, 0.0f);
    ray_march_triplane_totals_kernel<<<blocks_for(N), THREADS, 0, (cudaStream_t)stream>>>(
        a, t_end);
    return (int)cudaGetLastError();
}

// composite: t0 (N) contiguous; writes y (N, 3), acc, depth (N), local
// (N, 4) and, unless weight is null, w (N, S).
int ngf_ray_march_triplane_shard_forward(long long N, int S,
                                         const float* sigma, long long s_rs, long long s_ss,
                                         const float* dist, long long t_rs, long long t_ss,
                                         float dist_const,
                                         const float* rgb, long long c_rs, long long c_ss,
                                         long long c_cs,
                                         const float* z, long long z_rs, long long z_ss,
                                         const float* t0, float thres,
                                         float* y, float* acc, float* depth, float* local,
                                         float* weight, void* stream) {
    Args a = triplane_args(N, S, sigma, s_rs, s_ss, dist, t_rs, t_ss, dist_const,
                           rgb, c_rs, c_ss, c_cs, nullptr, 0.0f, thres);
    a.z = z; a.z_rs = z_rs; a.z_ss = z_ss;
    a.t0 = t0;
    ray_march_triplane_forward_kernel<true><<<blocks_for(N), THREADS, 0, (cudaStream_t)stream>>>(
        a, nullptr, y, acc, depth, weight, local);
    return (int)cudaGetLastError();
}

// backward: g_y (N, 3), g_acc, g_tend (N): contiguous or null; writes d_sigma
// (N, S), d_rgb (N, S, 3) and d_t0 (N).
int ngf_ray_march_triplane_shard_backward(long long N, int S,
                                          const float* sigma, long long s_rs, long long s_ss,
                                          const float* dist, long long t_rs, long long t_ss,
                                          float dist_const,
                                          const float* rgb, long long c_rs, long long c_ss,
                                          long long c_cs,
                                          const float* t0, float thres,
                                          const float* g_y, const float* g_acc,
                                          const float* g_tend,
                                          float* d_sigma, float* d_rgb, float* d_t0,
                                          void* stream) {
    Args a = triplane_args(N, S, sigma, s_rs, s_ss, dist, t_rs, t_ss, dist_const,
                           rgb, c_rs, c_ss, c_cs, nullptr, 0.0f, thres);
    a.t0 = t0;
    ray_march_triplane_backward_kernel<true><<<blocks_for(N), THREADS, tstart_bytes(S),
                                               (cudaStream_t)stream>>>(
        a, nullptr, g_y, g_acc, g_tend, nullptr, d_sigma, d_rgb, d_t0);
    return (int)cudaGetLastError();
}

// The footprint of K5's kernel `which` (0 NeuTex forward, 1 NeuTex backward,
// 2 tri-plane forward, 3 tri-plane backward, 4 shard forward, 5 shard
// backward, 6 shard totals, 7 top-K colour forward, 8 its backward) on this
// card at rays of S samples: out[0] the blocks of eight warps an SM holds at
// once, out[1] its registers a thread, out[2] its local memory a thread in
// bytes (spills; 0 without). Returns the cudaError_t of the queries.
int ngf_ray_march_footprint(int which, int S, int* out) {
    const void* fns[9] = {
        reinterpret_cast<const void*>(ray_march_neutex_forward_kernel),
        reinterpret_cast<const void*>(ray_march_neutex_backward_kernel),
        reinterpret_cast<const void*>(ray_march_triplane_forward_kernel<false>),
        reinterpret_cast<const void*>(ray_march_triplane_backward_kernel<false>),
        reinterpret_cast<const void*>(ray_march_triplane_forward_kernel<true>),
        reinterpret_cast<const void*>(ray_march_triplane_backward_kernel<true>),
        reinterpret_cast<const void*>(ray_march_triplane_totals_kernel),
        reinterpret_cast<const void*>(ray_march_topk_forward_kernel),
        reinterpret_cast<const void*>(ray_march_topk_backward_kernel)};
    if (which < 0 || which > 8) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
    if (err != cudaSuccess) return (int)err;
    out[1] = attr.numRegs;
    out[2] = (int)attr.localSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], fns[which], THREADS, (which == 1 || which == 3 || which == 5) ? tstart_bytes(S) : 0);
}

const char* ngf_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
