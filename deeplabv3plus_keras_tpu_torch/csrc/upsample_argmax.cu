// Fused bilinear upsample (x s) + first-max argmax over channels.
//
// Replaces the Pallas TPU kernel upsample_argmax
// (deeplabv3plus_keras_tpu/kernels/upsample_argmax.py:88, body _kernel:58):
// labels (B, h*s, w*s) int32 = argmax over C of the TF half-pixel bilinear
// x s upsample (edge clamp) of logits (B, h, w, C) float32.  The upsampled
// (B, h*s, w*s, C) tensor is never written.
//
// Bound: memory.  The least traffic is the logits read once
// (B*h*w*C*4 bytes) and the labels written once (B*h*w*s*s*4 bytes); the
// work is about 6*C flops per output pixel, far below the card's
// operations-per-byte balance.  Design: one thread per output pixel,
// neighbouring threads on neighbouring output columns, so the s*s outputs
// that share a 2x2 source neighbourhood read the same C-vectors and L1
// serves all but the first read; the labels store is contiguous.
//
// Arithmetic follows the JAX kernel's order exactly (upsample_argmax.py
// :69-77): output row q*s+p blends rows clamp(q+d_p) and clamp(q+d_p+1)
// as a*(1-w_p) + b*w_p, then the same along columns, with the phase
// weights of _phase_weights (:39-46) computed in double and rounded to
// float.  Explicit _rn intrinsics keep nvcc from contracting the blends
// into FMAs.  Ties keep the first channel (strict >), as the JAX select
// chain and torch.argmax do.
//
// C interface: upsample_argmax(...) returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void phase(int o, int s, int n, int* i0, int* i1,
                                      float* w0, float* w1) {
    const int q = o / s;
    const int p = o - q * s;
    const double off = (p + 0.5) / s - 0.5;
    const double d = floor(off);
    const double w = off - d;
    int a = q + (int)d;
    int b = a + 1;
    *i0 = a < 0 ? 0 : (a > n - 1 ? n - 1 : a);
    *i1 = b < 0 ? 0 : (b > n - 1 ? n - 1 : b);
    *w0 = (float)(1.0 - w);
    *w1 = (float)w;
}

__device__ __forceinline__ float lerp_rn(float a, float b, float wa, float wb) {
    return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

// grid: (ceil(Wout / blockDim.x), Hout, B)
__global__ void upsample_argmax_kernel(const float* __restrict__ x,
                                       int32_t* __restrict__ out,
                                       int h, int w, int C, int s) {
    const int ox = blockIdx.x * blockDim.x + threadIdx.x;
    const int Wout = w * s;
    if (ox >= Wout) return;
    const int oy = blockIdx.y;
    const int b = blockIdx.z;

    int r0, r1, c0, c1;
    float wr0, wr1, wc0, wc1;
    phase(oy, s, h, &r0, &r1, &wr0, &wr1);
    phase(ox, s, w, &c0, &c1, &wc0, &wc1);

    const float* xb = x + (size_t)b * h * w * C;
    const float* p00 = xb + ((size_t)r0 * w + c0) * C;
    const float* p10 = xb + ((size_t)r1 * w + c0) * C;
    const float* p01 = xb + ((size_t)r0 * w + c1) * C;
    const float* p11 = xb + ((size_t)r1 * w + c1) * C;

    float best = 0.f;
    int idx = 0;
    for (int c = 0; c < C; ++c) {
        const float left = lerp_rn(p00[c], p10[c], wr0, wr1);
        const float right = lerp_rn(p01[c], p11[c], wr0, wr1);
        const float v = lerp_rn(left, right, wc0, wc1);
        if (c == 0 || v > best) {
            best = v;
            idx = c;
        }
    }
    out[((size_t)b * h * s + oy) * Wout + ox] = idx;
}

}  // namespace

// x (B,h,w,C) float32 contiguous, out (B,h*s,w*s) int32 contiguous.
extern "C" int upsample_argmax(const void* x, void* out, int B, int h, int w,
                               int C, int s, void* stream) {
    if (s < 1 || C < 1) return (int)cudaErrorInvalidValue;
    const int threads = 128;
    dim3 grid((w * s + threads - 1) / threads, h * s, B);
    upsample_argmax_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (int32_t*)out, h, w, C, s);
    return (int)cudaGetLastError();
}
