// Depthwise 3x3 convolution, stride 1, dilation 1, zero ("SAME") padding,
// channels-first: the tensors are NCHW-contiguous, so each (b, c) plane is
// one contiguous H x W array with W the minor axis.  Forward (K6) and
// backward (K7: the input gradient dx and the weight gradient dk).
//
// Replaces the Pallas TPU kernels _dw_fwd_padded
// (deeplabv3plus_keras_tpu/kernels/depthwise3.py:105) and _dw_bwd_padded
// (depthwise3.py:185), which the JAX package runs under
// DLV3_DW_LAYOUT=bhcw on a (B, H, C, W) layout with W on the TPU's lanes.
// The TPU DMA'd an H-halo slab per grid step and shifted it along the
// lanes; dk lived in one output block carried across its sequential grid.
// Here:
//
// - One block per (32 x 32 output tile, channel, image): it loads the
//   34 x 34 halo tile of its plane into shared memory (zero outside the
//   image, which is the padding), keeps the nine taps in registers, and
//   each thread computes 4 rows of one column, sliding a 3 x 3 window of
//   registers down the column (3 shared-memory reads per output).  Warps
//   run along W, so global loads and stores coalesce.  Every tap is
//   bounds-checked by the tile load, so odd H and W (253, 127) work.
// - dx is the same stencil over g with the taps reversed (the JAX
//   _bwd_kernel's decomposition, depthwise3.py:151-160), from the same
//   device code as the forward.
// - dk[c, t] = sum over (b, h, w) of x[shifted by tap t] * g: a block
//   that computes dx also holds its x tile and sums the nine products over
//   its 32 x 32 outputs (registers, then a fixed-order warp and block
//   reduction), and writes one (9,) slice of a (B * tiles, 9, C) float
//   buffer.  A second kernel adds those partials in a fixed order.  No
//   atomics, and the tiling depends on the shape alone, so dk is the same
//   bit for bit from run to run.
//
// Bound: memory.  The forward does 9 multiply-adds per output for 8 bytes
// moved (float32), the backward 18 for 12: far below the card's
// operations-per-byte balance.  The least time is x read and y written
// (forward: 2 tensors), or x and g read and dx written (backward: 3), over
// the device memory rate.  The halo re-reads 13 % more of the input, most
// of it from L2.  Accumulation is float32 for float32 and bfloat16.
//
// C interface: dw_cf_fwd(...) and dw_cf_bwd(...) return cudaGetLastError()
// after their launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;       // tile columns = threadIdx.x
constexpr int TY = 8;        // threadIdx.y
constexpr int R = 4;         // output rows per thread
constexpr int TH = TY * R;   // tile rows
constexpr int SW = TW + 2;   // shared tile: one halo column on each side
constexpr int SH = TH + 2;   // and one halo row above and below
constexpr int THREADS = TW * TY;
constexpr int DK_CH = 32;    // channels of a dk_final block (threadIdx.x)
constexpr int DK_LANES = 8;  // partial lanes of a dk_final block (threadIdx.y)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The halo tile of one plane whose first output is (h0, w0): s[r][j] =
// plane[h0 + r - 1][w0 + j - 1], zero outside the image.
template <typename T>
__device__ __forceinline__ void load_tile(float (*s)[SW], const T* __restrict__ plane,
                                          int H, int W, int h0, int w0) {
    const int tid = threadIdx.y * TW + threadIdx.x;
    for (int i = tid; i < SH * SW; i += THREADS) {
        const int r = i / SW;
        const int j = i - r * SW;
        const int h = h0 + r - 1;
        const int w = w0 + j - 1;
        s[r][j] = (h >= 0 && h < H && w >= 0 && w < W) ? to_f(plane[(size_t)h * W + w]) : 0.f;
    }
}

// out[i] = sum over (dy, dx) of s[r0 + i + dy][tx + dx] * k[dy * 3 + dx]
// (or k[8 - that] with REV: the taps reversed, for dx), r0 = 4 * threadIdx.y.
template <bool REV>
__device__ __forceinline__ void stencil(const float (*s)[SW], const float* k, float* out) {
    const int tx = threadIdx.x;
    const int r0 = threadIdx.y * R;
    float kk[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) kk[t] = k[REV ? 8 - t : t];
    float a0 = s[r0][tx], a1 = s[r0][tx + 1], a2 = s[r0][tx + 2];
    float b0 = s[r0 + 1][tx], b1 = s[r0 + 1][tx + 1], b2 = s[r0 + 1][tx + 2];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const float c0 = s[r0 + i + 2][tx], c1 = s[r0 + i + 2][tx + 1], c2 = s[r0 + i + 2][tx + 2];
        float acc = 0.f;
        acc = fmaf(a0, kk[0], acc);
        acc = fmaf(a1, kk[1], acc);
        acc = fmaf(a2, kk[2], acc);
        acc = fmaf(b0, kk[3], acc);
        acc = fmaf(b1, kk[4], acc);
        acc = fmaf(b2, kk[5], acc);
        acc = fmaf(c0, kk[6], acc);
        acc = fmaf(c1, kk[7], acc);
        acc = fmaf(c2, kk[8], acc);
        out[i] = acc;
        a0 = b0; a1 = b1; a2 = b2;
        b0 = c0; b1 = c1; b2 = c2;
    }
}

template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ plane, const float* out,
                                           int H, int W, int h0, int w0) {
    const int w = w0 + threadIdx.x;
    if (w >= W) return;
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int h = h0 + threadIdx.y * R + i;
        if (h < H) store(plane + (size_t)h * W + w, out[i]);
    }
}

// grid: (tiles of the plane, C, B); block (TW, TY).
template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_cf_fwd_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                 T* __restrict__ y, int C, int H, int W, int tiles_w) {
    __shared__ float s[SH][SW];
    const int c = blockIdx.y;
    const int b = blockIdx.z;
    const int h0 = (blockIdx.x / tiles_w) * TH;
    const int w0 = (blockIdx.x % tiles_w) * TW;
    const size_t plane = ((size_t)b * C + c) * H * W;
    load_tile(s, x + plane, H, W, h0, w0);
    float k[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) k[t] = taps[t * C + c];
    __syncthreads();
    float out[R];
    stencil<false>(s, k, out);
    store_tile(y + plane, out, H, W, h0, w0);
}

// grid: (tiles of the plane, C, B); block (TW, TY).  dx (when DX) as the
// reversed-tap stencil over g; the block's dk partial (when DK) into
// partial[(b * tiles + tile), t, c].
template <typename T, bool DX, bool DK>
__global__ void __launch_bounds__(THREADS)
dw_cf_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ taps, T* __restrict__ dx,
                 float* __restrict__ partial, int C, int H, int W, int tiles_w) {
    __shared__ float sg[SH][SW];
    __shared__ float sx[DK ? SH : 1][SW];
    __shared__ float red[TY][9];
    const int c = blockIdx.y;
    const int b = blockIdx.z;
    const int h0 = (blockIdx.x / tiles_w) * TH;
    const int w0 = (blockIdx.x % tiles_w) * TW;
    const size_t plane = ((size_t)b * C + c) * H * W;
    load_tile(sg, g + plane, H, W, h0, w0);
    if (DK) load_tile(sx, x + plane, H, W, h0, w0);
    __syncthreads();

    if (DX) {
        float k[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) k[t] = taps[t * C + c];
        float out[R];
        stencil<true>(sg, k, out);
        store_tile(dx + plane, out, H, W, h0, w0);
    }

    if (DK) {
        // g outside the image was loaded as 0, so those outputs add nothing
        const int tx = threadIdx.x;
        const int r0 = threadIdx.y * R;
        float acc[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) acc[t] = 0.f;
        float a0 = sx[r0][tx], a1 = sx[r0][tx + 1], a2 = sx[r0][tx + 2];
        float b0 = sx[r0 + 1][tx], b1 = sx[r0 + 1][tx + 1], b2 = sx[r0 + 1][tx + 2];
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const float c0 = sx[r0 + i + 2][tx], c1 = sx[r0 + i + 2][tx + 1], c2 = sx[r0 + i + 2][tx + 2];
            const float gv = sg[r0 + i + 1][tx + 1];
            acc[0] = fmaf(a0, gv, acc[0]);
            acc[1] = fmaf(a1, gv, acc[1]);
            acc[2] = fmaf(a2, gv, acc[2]);
            acc[3] = fmaf(b0, gv, acc[3]);
            acc[4] = fmaf(b1, gv, acc[4]);
            acc[5] = fmaf(b2, gv, acc[5]);
            acc[6] = fmaf(c0, gv, acc[6]);
            acc[7] = fmaf(c1, gv, acc[7]);
            acc[8] = fmaf(c2, gv, acc[8]);
            a0 = b0; a1 = b1; a2 = b2;
            b0 = c0; b1 = c1; b2 = c2;
        }
        // a warp is one threadIdx.y: reduce its 32 lanes by shuffles, then
        // thread t < 9 adds the warps' sums in order
#pragma unroll
        for (int t = 0; t < 9; ++t) {
            float v = acc[t];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
            if (tx == 0) red[threadIdx.y][t] = v;
        }
        __syncthreads();
        const int tid = threadIdx.y * TW + tx;
        if (tid < 9) {
            float s = red[0][tid];
#pragma unroll
            for (int l = 1; l < TY; ++l) s += red[l][tid];
            const size_t slot = (size_t)b * gridDim.x + blockIdx.x;
            partial[(slot * 9 + tid) * C + c] = s;
        }
    }
}

// grid: (ceil(C / DK_CH), 9); block (DK_CH, DK_LANES).  dk[c, t] = the sum
// of partial[:, t, c] over the n slots: lane y sums slots y, y + DK_LANES,
// ... in order, then lane 0 adds the lanes in order.  dk is (C, 9) float,
// the (C, 1, 3, 3) weight layout.
__global__ void dw_cf_dk_final(const float* __restrict__ partial, float* __restrict__ dk,
                               int n, int C) {
    __shared__ float red[DK_LANES][DK_CH];
    const int c = blockIdx.x * DK_CH + threadIdx.x;
    const int t = blockIdx.y;
    const int lane = threadIdx.y;
    float s = 0.f;
    if (c < C) {
        const float* p = partial + (size_t)t * C + c;
#pragma unroll 4
        for (int i = lane; i < n; i += DK_LANES) s += p[(size_t)i * 9 * C];
    }
    red[lane][threadIdx.x] = s;
    __syncthreads();
    if (lane == 0 && c < C) {
        float total = red[0][threadIdx.x];
#pragma unroll
        for (int l = 1; l < DK_LANES; ++l) total += red[l][threadIdx.x];
        dk[(size_t)c * 9 + t] = total;
    }
}

template <typename T, bool DX, bool DK>
void launch_bwd(const void* x, const void* g, const float* taps, void* dx,
                float* partial, int B, int C, int H, int W, int tiles_w,
                int tiles, cudaStream_t st) {
    dw_cf_bwd_kernel<T, DX, DK><<<dim3(tiles, C, B), dim3(TW, TY), 0, st>>>(
        (const T*)x, (const T*)g, taps, (T*)dx, partial, C, H, W, tiles_w);
}

template <typename T>
void launch_bwd_t(const void* x, const void* g, const float* taps, void* dx,
                  float* dk, float* partial, int B, int C, int H, int W,
                  cudaStream_t st) {
    const int tiles_w = (W + TW - 1) / TW;
    const int tiles = ((H + TH - 1) / TH) * tiles_w;
    if (dx && dk)
        launch_bwd<T, true, true>(x, g, taps, dx, partial, B, C, H, W, tiles_w, tiles, st);
    else if (dx)
        launch_bwd<T, true, false>(x, g, taps, dx, partial, B, C, H, W, tiles_w, tiles, st);
    else
        launch_bwd<T, false, true>(x, g, taps, dx, partial, B, C, H, W, tiles_w, tiles, st);
    if (dk)
        dw_cf_dk_final<<<dim3((C + DK_CH - 1) / DK_CH, 9), dim3(DK_CH, DK_LANES), 0, st>>>(
            partial, dk, B * tiles, C);
}

bool bad_shape(int dtype, int B, int C, int H, int W) {
    if (dtype != 0 && dtype != 1) return true;
    if (B < 1 || C < 1 || H < 1 || W < 1 || B > 65535 || C > 65535) return true;
    const long long tiles = (long long)((H + TH - 1) / TH) * ((W + TW - 1) / TW);
    return tiles > 0x7fffffffLL;
}

}  // namespace

// The number of dk partial slots dw_cf_bwd needs: B * (tiles of a plane).
extern "C" int dw_cf_slots(int B, int H, int W) {
    return B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// dtype: 0 = float32, 1 = bfloat16.  x, y (B, C, H, W) NCHW-contiguous;
// taps (9, C) float32, tap t = 3 * dy + dx.
extern "C" int dw_cf_fwd(const void* x, const void* taps, void* y, int dtype,
                         int B, int C, int H, int W, void* stream) {
    if (bad_shape(dtype, B, C, H, W)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int tiles_w = (W + TW - 1) / TW;
    const int tiles = ((H + TH - 1) / TH) * tiles_w;
    const dim3 grid(tiles, C, B), block(TW, TY);
    if (dtype == 0)
        dw_cf_fwd_kernel<float><<<grid, block, 0, st>>>(
            (const float*)x, (const float*)taps, (float*)y, C, H, W, tiles_w);
    else
        dw_cf_fwd_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
            (const __nv_bfloat16*)x, (const float*)taps, (__nv_bfloat16*)y, C, H, W, tiles_w);
    return (int)cudaGetLastError();
}

// x, g, dx (B, C, H, W) NCHW-contiguous, x and g of dtype; dx or null
// (taps (9, C) float32 read only for dx); dk (C, 9) float32 or null, with
// partial (dw_cf_slots(B, H, W), 9, C) float32 scratch.
extern "C" int dw_cf_bwd(const void* x, const void* g, const void* taps, void* dx,
                         void* dk, void* partial, int dtype, int B, int C, int H,
                         int W, void* stream) {
    if (bad_shape(dtype, B, C, H, W) || (!dx && !dk) || (dk && !partial))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const float* t = (const float*)taps;
    if (dtype == 0)
        launch_bwd_t<float>(x, g, t, dx, (float*)dk, (float*)partial, B, C, H, W, st);
    else
        launch_bwd_t<__nv_bfloat16>(x, g, t, dx, (float*)dk, (float*)partial, B, C, H, W, st);
    return (int)cudaGetLastError();
}
