// Helpers shared by the NHWC depthwise kernels, depthwise_fwd.cu (K2/K3)
// and depthwise_bwd.cu (K4/K5): 16-byte channel-vector loads and stores,
// the window buffers in shared memory, the mbarrier and TMA copy helpers,
// the narrow instantiation's window load, the register strip of one kernel
// row, and the tensor map of an NHWC tensor whose box is one window.
//
// Each .cu file that includes this header is its own shared library, so
// everything here has internal linkage.

#pragma once

#include <cuda.h>  // CUtensorMap (the tensor map is encoded through the runtime's driver entry point)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 4;  // outputs per thread along W

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// V elements of T at p (16-byte aligned when V * sizeof(T) == 16) as floats.
template <typename T, int V>
__device__ __forceinline__ void load_f(const T* p, float (&v)[V]) {
    if constexpr (V == 1) {
        if constexpr (sizeof(T) == 4) v[0] = *(const float*)p;
        else v[0] = __bfloat162float(*(const __nv_bfloat16*)p);
    } else if constexpr (sizeof(T) == 4) {
        static_assert(V == 4, "float32 vectors are 4 channels");
        const float4 f = *reinterpret_cast<const float4*>(p);
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
        static_assert(V == 8, "bfloat16 vectors are 8 channels");
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
            v[2 * i] = f.x;
            v[2 * i + 1] = f.y;
        }
    }
}

template <typename T, int V>
__device__ __forceinline__ void store_f(T* p, const float (&v)[V]) {
    if constexpr (V == 1) {
        if constexpr (sizeof(T) == 4) *(float*)p = v[0];
        else *(__nv_bfloat16*)p = __float2bfloat16(v[0]);
    } else if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
            w[i] = *reinterpret_cast<const uint32_t*>(&h);
        }
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    }
}

// V float taps at p; p is 16-byte aligned when V > 1 (C is a multiple of V).
template <int V>
__device__ __forceinline__ void load_taps(const float* p, float* out) {
    if constexpr (V == 1) {
        out[0] = *p;
    } else {
#pragma unroll
        for (int i = 0; i < V; i += 4) {
            const float4 f = *reinterpret_cast<const float4*>(p + i);
            out[i] = f.x; out[i + 1] = f.y; out[i + 2] = f.z; out[i + 3] = f.w;
        }
    }
}

// Shared bytes of one window buffer, rounded up to 128 (a TMA destination).
__host__ __device__ __forceinline__ int buf_bytes(int wr, int wc, int cbp, int itemsize) {
    return (wr * wc * cbp * itemsize + 127) & ~127;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for phase `parity` of the barrier to complete; a copy that never
// lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    for (int i = 0;; ++i) {
        unsigned ok;
        asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n" : "=r"(ok) : "r"(smem_u32(bar)), "r"(parity) : "memory");
        if (ok) return;
        if (i > (1 << 22)) __trap();
    }
}

// One TMA copy of the (1, rows, cols, cb) box at (c0, x0, y0, b) of the
// tensor map into dst; elements outside the tensor arrive as zeros.  The
// barrier expects `bytes` and completes when they have landed.
__device__ __forceinline__ void tma_window(void* dst, const CUtensorMap* map, uint64_t* bar,
                                           int c0, int x0, int y0, int b, int bytes) {
    const unsigned m = smem_u32(bar);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(m), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        ::"r"(smem_u32(dst)), "l"((unsigned long long)map), "r"(c0), "r"(x0), "r"(y0), "r"(b), "r"(m)
        : "memory");
}

// The narrow instantiation's window load from an (H, W, C) image at xb:
// every thread copies channel tid % nv of pixels tid / nv, tid / nv + step,
// ... (step = threads / nv) of the wr x wc window whose top-left pixel is
// (iy0, ix0), zero outside the image; c is the thread's channel.  The
// (row, column) of the next pixel is stepped without a division.
template <typename T>
__device__ __forceinline__ void load_window(T* buf, const T* __restrict__ xb, int H, int W, int C,
                                            int nv, int step, int iy0, int ix0, int wr_n, int wc_n,
                                            int c) {
    const int p = threadIdx.x / nv;
    int wr = p / wc_n;
    int wc = p - wr * wc_n;
    while (wr < wr_n) {
        const int iy = iy0 + wr, ix = ix0 + wc;
        const bool in = c < C && iy >= 0 && iy < H && ix >= 0 && ix < W;
        buf[(wr * wc_n + wc) * nv + threadIdx.x % nv] = in ? xb[((size_t)iy * W + ix) * C + c] : zero<T>();
        wc += step;
        while (wc >= wc_n) { wc -= wc_n; ++wr; }
    }
}

// acc[j] += one kernel row's taps tk applied to the strip's input row:
// input column col (load(col, xv) reads it) reaches output (col - kx) / S
// through tap kx, so each of the (R-1)*S + K columns is read once and used
// by every output it reaches.
template <int K, int S, int V, typename Load>
__device__ __forceinline__ void row_taps(Load load, const float (&tk)[K][V], float (&acc)[R][V]) {
#pragma unroll
    for (int col = 0; col < (R - 1) * S + K; ++col) {
        float xv[V];
        load(col, xv);
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
            const int d = col - kx;  // compile-time: which output this tap reaches
            if (d >= 0 && d % S == 0 && d / S < R) {
#pragma unroll
                for (int e = 0; e < V; ++e) acc[d / S][e] = fmaf(xv[e], tk[kx][e], acc[d / S][e]);
            }
        }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The tensor map of x (B, H, W, C) whose box is one window: (cb, cols, rows, 1).
int window_map(CUtensorMap* map, const void* x, int dtype, int B, int H, int W, int C,
               int cb, int cols, int rows) {
    static EncodeTiled encode = nullptr;
    if (!encode) {
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", (void**)&encode, cudaEnableDefault, &q) != cudaSuccess
            || q != cudaDriverEntryPointSuccess || !encode) {
            encode = nullptr;
            return (int)cudaErrorNotSupported;
        }
    }
    const cuuint64_t es = dtype == 0 ? 4 : 2;
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {C * es, (cuuint64_t)W * C * es, (cuuint64_t)H * W * C * es};
    const cuuint32_t box[4] = {(cuuint32_t)cb, (cuuint32_t)cols, (cuuint32_t)rows, 1};
    const cuuint32_t one[4] = {1, 1, 1, 1};
    const CUresult r = encode(map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                              4, (void*)x, dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
