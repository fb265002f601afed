// Depthwise k x k convolution forward, NHWC, TF "SAME" zero padding,
// stride 1 (any dilation) or stride 2.
//
// Replaces the Pallas TPU kernels _dw_fwd_nhwc (stride 1,
// deeplabv3plus_keras_tpu/kernels/depthwise3.py:318) and _dw_fwd_s2
// (stride 2 over four parity planes, depthwise3.py:684).  On the TPU the
// stride-2 case needed parity planes so that every tap is a static slice
// of a VMEM slab; here each thread gathers its own taps, so stride 2 is
// the same loop with the input index 2*o + d - lo, where lo is the SAME
// padding before the first row/column.  That equals the parity-plane
// arithmetic and needs no split or merge of the input.
//
// Bound: memory.  Each output does k*k fused multiply-adds for 4 bytes
// written and (stride 1) about 4 bytes read, far below the card's
// operations-per-byte balance, so the least time is (|x| + |y|) bytes over
// the device memory rate.  Design for that: one thread per output element
// with the channel fastest, so a warp's loads and stores are contiguous;
// the k*k taps of neighbouring outputs overlap and are served by L1/L2,
// not re-read from device memory.  Taps come as a (k*k, C) float table.
// Accumulation is float32 for float32 and bfloat16 inputs.  Every tap is
// bounds-checked, so a dilation larger than the map (taps wholly in the
// padding) is handled.
//
// C interface: dw_fwd(...) returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// grid: (ceil(Wo*C / blockDim.x), Ho, B); one thread per (wo, c) of row ho.
template <typename T, int K, int S>
__global__ void dw_fwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ taps,
                              T* __restrict__ y,
                              int H, int W, int C, int Ho, int Wo,
                              int dh, int dw, int pad_t, int pad_l) {
    const int wc = blockIdx.x * blockDim.x + threadIdx.x;
    if (wc >= Wo * C) return;
    const int ho = blockIdx.y;
    const int b = blockIdx.z;
    const int wo = wc / C;
    const int c = wc - wo * C;

    const T* xb = x + (size_t)b * H * W * C + c;
    const int iy0 = ho * S - pad_t;
    const int ix0 = wo * S - pad_l;
    float acc = 0.f;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
        const int iy = iy0 + ky * dh;
        if (iy < 0 || iy >= H) continue;
        const T* xr = xb + (size_t)iy * W * C;
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
            const int ix = ix0 + kx * dw;
            if (ix < 0 || ix >= W) continue;
            acc = fmaf(to_f(xr[(size_t)ix * C]), taps[(ky * K + kx) * C + c], acc);
        }
    }
    store(y + (((size_t)b * Ho + ho) * Wo + wo) * C + c, acc);
}

template <typename T, int K>
void launch_k(const void* x, const float* taps, void* y, int B, int H, int W,
              int C, int Ho, int Wo, int stride, int dh, int dw, int pad_t,
              int pad_l, cudaStream_t st) {
    const int threads = 256;
    dim3 grid((Wo * C + threads - 1) / threads, Ho, B);
    if (stride == 1)
        dw_fwd_kernel<T, K, 1><<<grid, threads, 0, st>>>(
            (const T*)x, taps, (T*)y, H, W, C, Ho, Wo, dh, dw, pad_t, pad_l);
    else
        dw_fwd_kernel<T, K, 2><<<grid, threads, 0, st>>>(
            (const T*)x, taps, (T*)y, H, W, C, Ho, Wo, dh, dw, pad_t, pad_l);
}

template <typename T>
int launch_t(const void* x, const float* taps, void* y, int B, int H, int W,
             int C, int Ho, int Wo, int k, int stride, int dh, int dw,
             int pad_t, int pad_l, cudaStream_t st) {
    switch (k) {
        case 3: launch_k<T, 3>(x, taps, y, B, H, W, C, Ho, Wo, stride, dh, dw, pad_t, pad_l, st); break;
        case 5: launch_k<T, 5>(x, taps, y, B, H, W, C, Ho, Wo, stride, dh, dw, pad_t, pad_l, st); break;
        case 7: launch_k<T, 7>(x, taps, y, B, H, W, C, Ho, Wo, stride, dh, dw, pad_t, pad_l, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (B,H,W,C), y (B,Ho,Wo,C), taps (k*k,C) float32.
extern "C" int dw_fwd(const void* x, const void* taps, void* y, int dtype,
                      int B, int H, int W, int C, int Ho, int Wo, int k,
                      int stride, int dh, int dw, int pad_t, int pad_l,
                      void* stream) {
    if ((stride != 1 && stride != 2) || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const float* t = (const float*)taps;
    int rc = dtype == 0
        ? launch_t<float>(x, t, y, B, H, W, C, Ho, Wo, k, stride, dh, dw, pad_t, pad_l, st)
        : launch_t<__nv_bfloat16>(x, t, y, B, H, W, C, Ho, Wo, k, stride, dh, dw, pad_t, pad_l, st);
    if (rc) return rc;
    return (int)cudaGetLastError();
}
