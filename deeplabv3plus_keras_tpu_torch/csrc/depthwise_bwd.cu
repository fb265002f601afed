// Depthwise k x k convolution backward, NHWC, TF "SAME" zero padding,
// stride 1 (any dilation) or stride 2: the input gradient dx and the
// weight gradient dk of depthwise_fwd.cu's forward.
//
// Replaces the Pallas TPU kernels _dw_bwd_nhwc (stride 1,
// deeplabv3plus_keras_tpu/kernels/depthwise3.py:422) and _dw_bwd_s2
// (stride 2 over four parity planes, depthwise3.py:798).  The TPU walked
// halo slabs (and, at stride 2, parity planes) so that every tap is a
// static VMEM slice, and carried dk in one output block across its
// sequential grid.  Here:
//
// - dx: one thread per input element (b, i, j, c), channel fastest.  It
//   gathers the outputs its taps reached: output row o took input row
//   i = S*o - pad_t + ky*dh, so o = (i + pad_t - ky*dh) / S when that is
//   an integer in range.  At stride 1 this is the forward stencil over g
//   with the taps reversed (the TPU's decomposition); at stride 2 it is the
//   parity-plane arithmetic without the split and merge.
// - dk: dk[t, c] = sum over (b, oy, ox) of x[shifted by tap t] * g.  Blocks
//   run in no order, so the reduction takes two passes with no atomics:
//   block (channel group, row tile) sums its tile into k*k float registers
//   per thread and writes one (k*k, 32) slice of a (tiles, k*k, C) float
//   buffer; a second kernel sums the tiles.  Every sum has a fixed order,
//   so dk is the same bit for bit from run to run.
//
// Bound: memory.  dx does k*k (stride 1) or about k*k/4 (stride 2) fused
// multiply-adds per element written, dk k*k per output element read: far
// below the card's operations-per-byte balance.  The least time is x and g
// read once and dx written once over the device memory rate.  Loads are
// coalesced (a warp holds 32 neighbouring channels); the k*k overlapping
// tap reads of neighbours are served by L1/L2.  Accumulation is float32
// for float32 and bfloat16 inputs.  Every tap is bounds-checked, so a tap
// wholly in the padding contributes nothing and its dk is exactly 0.
//
// C interface: dw_bwd(...) launches the dx kernel when dx is not null and
// the two dk passes when dk is not null, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DK_CH = 32;    // channels of a dk block (threadIdx.x)
constexpr int DK_LANES = 8;  // column lanes of a dk block (threadIdx.y)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// grid: (ceil(W*C / blockDim.x), H, B); one thread per (j, c) of input row i.
template <typename T, int K, int S>
__global__ void dw_bwd_dx_kernel(const T* __restrict__ g,
                                 const float* __restrict__ taps,
                                 T* __restrict__ dx,
                                 int H, int W, int C, int Ho, int Wo,
                                 int dh, int dw, int pad_t, int pad_l) {
    const int jc = blockIdx.x * blockDim.x + threadIdx.x;
    if (jc >= W * C) return;
    const int i = blockIdx.y;
    const int b = blockIdx.z;
    const int j = jc / C;
    const int c = jc - j * C;

    const T* gb = g + (size_t)b * Ho * Wo * C + c;
    float acc = 0.f;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
        int oy = i + pad_t - ky * dh;  // S * (output row)
        if (oy < 0) continue;
        if (S == 2) {
            if (oy & 1) continue;
            oy >>= 1;
        }
        if (oy >= Ho) continue;
        const T* gr = gb + (size_t)oy * Wo * C;
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
            int ox = j + pad_l - kx * dw;
            if (ox < 0) continue;
            if (S == 2) {
                if (ox & 1) continue;
                ox >>= 1;
            }
            if (ox >= Wo) continue;
            acc = fmaf(to_f(gr[(size_t)ox * C]), taps[(ky * K + kx) * C + c], acc);
        }
    }
    store(dx + (((size_t)b * H + i) * W + j) * C + c, acc);
}

// grid: (ceil(C / DK_CH), tiles); block (DK_CH, DK_LANES).  Block (cg, tile)
// sums x_shift_t * g over output rows [tile*rows, (tile+1)*rows) of the
// B*Ho rows, every column; lane y takes columns y, y + DK_LANES, ...
// partial[tile, t, c] is the lanes' sum, added in lane order.
template <typename T, int K, int S>
__global__ void dw_bwd_dk_partial(const T* __restrict__ x,
                                  const T* __restrict__ g,
                                  float* __restrict__ partial,
                                  int B, int H, int W, int C, int Ho, int Wo,
                                  int dh, int dw, int pad_t, int pad_l,
                                  int rows) {
    __shared__ float red[DK_LANES][DK_CH];
    const int c = blockIdx.x * DK_CH + threadIdx.x;
    const int tile = blockIdx.y;
    const int lane = threadIdx.y;

    float acc[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) acc[t] = 0.f;

    if (c < C) {
        const int r0 = tile * rows;
        const int r1 = min(r0 + rows, B * Ho);
        for (int r = r0; r < r1; ++r) {  // r = b * Ho + oy
            const int b = r / Ho;
            const int oy = r - b * Ho;
            const T* xb = x + (size_t)b * H * W * C + c;
            const T* gr = g + (size_t)r * Wo * C + c;
            const int iy0 = oy * S - pad_t;
            for (int ox = lane; ox < Wo; ox += DK_LANES) {
                const float gv = to_f(gr[(size_t)ox * C]);
                const int ix0 = ox * S - pad_l;
#pragma unroll
                for (int ky = 0; ky < K; ++ky) {
                    const int iy = iy0 + ky * dh;
                    if (iy < 0 || iy >= H) continue;
                    const T* xr = xb + (size_t)iy * W * C;
#pragma unroll
                    for (int kx = 0; kx < K; ++kx) {
                        const int ix = ix0 + kx * dw;
                        if (ix < 0 || ix >= W) continue;
                        acc[ky * K + kx] = fmaf(to_f(xr[(size_t)ix * C]), gv, acc[ky * K + kx]);
                    }
                }
            }
        }
    }

    float* out = partial + (size_t)tile * K * K * C;
#pragma unroll
    for (int t = 0; t < K * K; ++t) {
        red[lane][threadIdx.x] = acc[t];
        __syncthreads();
        if (lane == 0 && c < C) {
            float s = red[0][threadIdx.x];
#pragma unroll
            for (int l = 1; l < DK_LANES; ++l) s += red[l][threadIdx.x];
            out[(size_t)t * C + c] = s;
        }
        __syncthreads();
    }
}

// grid: (ceil(C / DK_CH), KK); block (DK_CH, DK_LANES).  dk[c, t] = sum of
// partial[:, t, c] over the tiles: lane y sums tiles y, y + DK_LANES, ...
// in order, then lane 0 adds the lanes in order.  dk is (C, KK) float, the
// (C, 1, k, k) weight layout.
__global__ void dw_bwd_dk_final(const float* __restrict__ partial,
                                float* __restrict__ dk,
                                int tiles, int KK, int C) {
    __shared__ float red[DK_LANES][DK_CH];
    const int c = blockIdx.x * DK_CH + threadIdx.x;
    const int t = blockIdx.y;
    const int lane = threadIdx.y;
    float s = 0.f;
    if (c < C) {
        const float* p = partial + (size_t)t * C + c;
#pragma unroll 4
        for (int i = lane; i < tiles; i += DK_LANES) s += p[(size_t)i * KK * C];
    }
    red[lane][threadIdx.x] = s;
    __syncthreads();
    if (lane == 0 && c < C) {
        float total = red[0][threadIdx.x];
#pragma unroll
        for (int l = 1; l < DK_LANES; ++l) total += red[l][threadIdx.x];
        dk[(size_t)c * KK + t] = total;
    }
}

template <typename T, int K, int S>
void launch_ks(const void* x, const void* g, const float* taps, void* dx,
               float* dk, float* partial, int B, int H, int W, int C, int Ho,
               int Wo, int dh, int dw, int pad_t, int pad_l, int rows,
               int tiles, cudaStream_t st) {
    if (dx) {
        const int threads = 256;
        dim3 grid((W * C + threads - 1) / threads, H, B);
        dw_bwd_dx_kernel<T, K, S><<<grid, threads, 0, st>>>(
            (const T*)g, taps, (T*)dx, H, W, C, Ho, Wo, dh, dw, pad_t, pad_l);
    }
    if (dk) {
        const int groups = (C + DK_CH - 1) / DK_CH;
        dim3 block(DK_CH, DK_LANES);
        dw_bwd_dk_partial<T, K, S><<<dim3(groups, tiles), block, 0, st>>>(
            (const T*)x, (const T*)g, partial, B, H, W, C, Ho, Wo, dh, dw,
            pad_t, pad_l, rows);
        dw_bwd_dk_final<<<dim3(groups, K * K), block, 0, st>>>(
            partial, dk, tiles, K * K, C);
    }
}

template <typename T, int K>
void launch_k(const void* x, const void* g, const float* taps, void* dx,
              float* dk, float* partial, int B, int H, int W, int C, int Ho,
              int Wo, int stride, int dh, int dw, int pad_t, int pad_l,
              int rows, int tiles, cudaStream_t st) {
    if (stride == 1)
        launch_ks<T, K, 1>(x, g, taps, dx, dk, partial, B, H, W, C, Ho, Wo,
                           dh, dw, pad_t, pad_l, rows, tiles, st);
    else
        launch_ks<T, K, 2>(x, g, taps, dx, dk, partial, B, H, W, C, Ho, Wo,
                           dh, dw, pad_t, pad_l, rows, tiles, st);
}

template <typename T>
int launch_t(const void* x, const void* g, const float* taps, void* dx,
             float* dk, float* partial, int B, int H, int W, int C, int Ho,
             int Wo, int k, int stride, int dh, int dw, int pad_t, int pad_l,
             int rows, int tiles, cudaStream_t st) {
    switch (k) {
        case 3: launch_k<T, 3>(x, g, taps, dx, dk, partial, B, H, W, C, Ho, Wo, stride, dh, dw, pad_t, pad_l, rows, tiles, st); break;
        case 5: launch_k<T, 5>(x, g, taps, dx, dk, partial, B, H, W, C, Ho, Wo, stride, dh, dw, pad_t, pad_l, rows, tiles, st); break;
        case 7: launch_k<T, 7>(x, g, taps, dx, dk, partial, B, H, W, C, Ho, Wo, stride, dh, dw, pad_t, pad_l, rows, tiles, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, g and dx).  x (B,H,W,C),
// g (B,Ho,Wo,C), dx (B,H,W,C) or null; taps (k*k,C) float32 (read only for
// dx); dk (C,k*k) float32 or null, with partial (tiles,k*k,C) float32
// scratch, tiles = ceil(B*Ho / rows).
extern "C" int dw_bwd(const void* x, const void* g, const void* taps,
                      void* dx, void* dk, void* partial, int dtype,
                      int B, int H, int W, int C, int Ho, int Wo, int k,
                      int stride, int dh, int dw, int pad_t, int pad_l,
                      int rows, int tiles, void* stream) {
    if ((stride != 1 && stride != 2) || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    if (dk && (rows < 1 || tiles < 1 || (long long)tiles * rows < (long long)B * Ho))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const float* t = (const float*)taps;
    float* dkf = (float*)dk;
    float* pf = (float*)partial;
    int rc = dtype == 0
        ? launch_t<float>(x, g, t, dx, dkf, pf, B, H, W, C, Ho, Wo, k, stride, dh, dw, pad_t, pad_l, rows, tiles, st)
        : launch_t<__nv_bfloat16>(x, g, t, dx, dkf, pf, B, H, W, C, Ho, Wo, k, stride, dh, dw, pad_t, pad_l, rows, tiles, st);
    if (rc) return rc;
    return (int)cudaGetLastError();
}
