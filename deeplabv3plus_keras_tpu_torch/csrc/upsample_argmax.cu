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
// work is about 7*C operations per output pixel, below the card's
// operations-per-byte balance, but close enough that instructions count.
//
// Design (the plan is kernels/upsample_argmax.py _upsample_argmax_plan):
// a block takes a band of bh source rows and bw source columns of one
// image and copies it with a one-pixel halo, clamped at the image's edges
// (which is the edge clamp of the upsample), by 4-byte cp.async (every
// copy of a thread in flight at once) into shared memory, as
// [row][channel][column]: the copy reads contiguous NHWC runs, and a
// thread then reads its neighbouring columns of one channel as float2s.
// At s = 2 (the label step's scale; the general path below takes 1.5x as
// long there on an H100, PERF.md section 6) a thread computes 2 output
// rows x 4 columns: the 4 source columns under them are blended along rows once for
// each output row, with the product of the row the two share taken once,
// and along a row each column's product that two labels share is taken
// once, as the JAX kernel shares its row blend (upsample_argmax.py:69-77).
// Other scales: a run of 4 adjacent labels of one output row, each
// blending its two columns.  A run of 4 labels is stored as one int4 where
// the row allows.  The phase weights come from the host (_phase_weights,
// :39-46: double, rounded to float) as a (2, s) float table in device
// memory, made once for each s, so no pixel does double arithmetic and
// every s >= 1 works; at s = 2 they are 1/4 and 3/4, exact in float.  A
// phase's source offset is integer arithmetic (phase_d).
//
// Arithmetic follows the JAX kernel's order exactly: output row q*s+p
// blends rows clamp(q+d_p) and clamp(q+d_p+1) as a*(1-w_p) + b*w_p, then
// the same along columns.  Explicit _rn intrinsics keep nvcc from
// contracting the blends into FMAs.  Ties keep the first channel (strict
// >), as the JAX select chain and torch.argmax do.
//
// C interface: upsample_argmax(...) returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// The source offset d of phase p at scale s: floor((p + 0.5) / s - 0.5),
// which is -1 exactly where p + 0.5 < s / 2.
__device__ __forceinline__ int phase_d(int p, int s) { return 2 * p + 1 < s ? -1 : 0; }

// One 4-byte asynchronous copy from global to shared memory: a thread's
// copies all fly at once instead of one load's latency after another.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ float lerp_rn(float a, float b, float wa, float wb) {
    return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

__device__ __forceinline__ void take(float v, int c, float& best, int& idx) {
    if (c == 0 || v > best) {
        best = v;
        idx = c;
    }
}

// A run of 4 labels from output column o: one int4 where the row allows
// (o + 4 <= Wout, 16-byte aligned), else the labels inside the row.
__device__ __forceinline__ void store_run(int32_t* dst, const int* idx, int o, int Wout, bool vec) {
    if (vec) {
        *reinterpret_cast<int4*>(dst) = make_int4(idx[0], idx[1], idx[2], idx[3]);
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (o + e < Wout) dst[e] = idx[e];
    }
}

// The window of the band whose first source row is q0 into win, by
// cp.async (every copy of a thread in flight at once).  Window row k is
// source row clamp(q0 - 1 + k), window column j is source column
// clamp(p0 - 1 + j): thread i copies elements i, i + THREADS, ... of each
// row's wpad * C run, stepping (column, channel) without a division.
__device__ __forceinline__ void load_band(float* win, const float* __restrict__ xb, int h, int w, int C,
                                          int q0, int p0, int bh, int wpad) {
    const int step_j = THREADS / C, step_c = THREADS % C;
    for (int k = 0; k < bh + 2; ++k) {
        const int row = min(max(q0 - 1 + k, 0), h - 1);
        const float* src = xb + (size_t)row * w * C;
        float* dst = win + (size_t)k * C * wpad;
        int j = threadIdx.x / C, c = threadIdx.x % C;
        while (j < wpad) {
            const int col = min(max(p0 - 1 + j, 0), w - 1);
            cp_async4(dst + c * wpad + j, src + (size_t)col * C + c);
            j += step_j;
            c += step_c;
            if (c >= C) { c -= C; ++j; }
        }
    }
}

// The labels of one band (first source row q0) from its window.
template <bool S2>
__device__ __forceinline__ void band_labels(const float* win, int32_t* __restrict__ out, int b, int h, int w,
                                            int C, int s, int q0, int p0, int bh, int bw, int wpad,
                                            const float* __restrict__ wt) {
    const int Wout = w * s;
    const bool vec = Wout % 4 == 0;  // a run of 4 labels is then one 16-byte store
    const int nq = min(bh, h - q0);  // source rows of this band
    if constexpr (S2) {
        // A task is output rows 2q, 2q + 1 (q = q0 + qq) x output columns
        // o .. o + 3, from source rows q - 1 .. q + 1 (window rows qq ..
        // qq + 2) and columns o/2 - 1 .. o/2 + 2 (window columns j .. j + 3,
        // j even: two float2s a row).  At s = 2 the weights are 1/4 and 3/4
        // (_phase_weights(2), exact in float), and each product that two
        // blends share is taken once: row q's x 3/4 by both output rows,
        // and along a row columns o/2 and o/2 + 1 x 3/4 by two labels each.
        // The values are those of lerp_rn on the same operands.
        constexpr float Q1 = 0.25f, Q3 = 0.75f;
        const int runs_x = bw / 2;
        for (int task = threadIdx.x; task < nq * runs_x; task += THREADS) {
            const int qq = task / runs_x;
            const int o = p0 * 2 + 4 * (task - qq * runs_x);
            if (o >= Wout) continue;
            const float* ra = win + (size_t)qq * C * wpad + (o / 2 - p0);
            const float* rb = ra + (size_t)C * wpad;
            const float* rc = rb + (size_t)C * wpad;
            float best[8];
            int idx[8];
            for (int c = 0; c < C; ++c) {
                const float2 a0 = *reinterpret_cast<const float2*>(ra + c * wpad);
                const float2 a1 = *reinterpret_cast<const float2*>(ra + c * wpad + 2);
                const float2 b0 = *reinterpret_cast<const float2*>(rb + c * wpad);
                const float2 b1 = *reinterpret_cast<const float2*>(rb + c * wpad + 2);
                const float2 c0 = *reinterpret_cast<const float2*>(rc + c * wpad);
                const float2 c1 = *reinterpret_cast<const float2*>(rc + c * wpad + 2);
                const float A[4] = {a0.x, a0.y, a1.x, a1.y};
                const float B[4] = {b0.x, b0.y, b1.x, b1.y};
                const float D[4] = {c0.x, c0.y, c1.x, c1.y};
                float u[4], v[4];  // rows 2q (q-1, q: 1/4, 3/4) and 2q + 1 (q, q+1: 3/4, 1/4)
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    const float bm = __fmul_rn(B[t], Q3);
                    u[t] = __fadd_rn(__fmul_rn(A[t], Q1), bm);
                    v[t] = __fadd_rn(bm, __fmul_rn(D[t], Q1));
                }
                float lab[8];
                const float u1 = __fmul_rn(u[1], Q3), u2 = __fmul_rn(u[2], Q3);
                lab[0] = __fadd_rn(__fmul_rn(u[0], Q1), u1);
                lab[1] = __fadd_rn(u1, __fmul_rn(u[2], Q1));
                lab[2] = __fadd_rn(__fmul_rn(u[1], Q1), u2);
                lab[3] = __fadd_rn(u2, __fmul_rn(u[3], Q1));
                const float v1 = __fmul_rn(v[1], Q3), v2 = __fmul_rn(v[2], Q3);
                lab[4] = __fadd_rn(__fmul_rn(v[0], Q1), v1);
                lab[5] = __fadd_rn(v1, __fmul_rn(v[2], Q1));
                lab[6] = __fadd_rn(__fmul_rn(v[1], Q1), v2);
                lab[7] = __fadd_rn(v2, __fmul_rn(v[3], Q1));
                if (c == 0) {
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                        best[e] = lab[e];
                        idx[e] = 0;
                    }
                } else {
#pragma unroll
                    for (int e = 0; e < 8; ++e)
                        if (lab[e] > best[e]) {
                            best[e] = lab[e];
                            idx[e] = c;
                        }
                }
            }
            int32_t* dst = out + ((size_t)b * h * 2 + (size_t)(q0 + qq) * 2) * Wout + o;
            store_run(dst, idx, o, Wout, vec);
            store_run(dst + Wout, idx + 4, o, Wout, vec);
        }
    } else {
        const int runs_x = bw * s / 4;  // runs of 4 labels in a tile row
        const int rows = nq * s;        // output rows of this band
        for (int run = threadIdx.x; run < rows * runs_x; run += THREADS) {
            const int ry = run / runs_x;
            const int o = p0 * s + 4 * (run - ry * runs_x);  // first output column
            if (o >= Wout) continue;
            const int qy = ry / s, pr = ry - qy * s;
            const int k0 = qy + phase_d(pr, s) + 1;  // window row of the upper source row
            const float wa = __ldg(wt + pr), wb = __ldg(wt + s + pr);
            const float* r0 = win + (size_t)k0 * C * wpad;
            const float* r1 = r0 + (size_t)C * wpad;
            float best[4] = {0.f, 0.f, 0.f, 0.f};
            int idx[4] = {0, 0, 0, 0};
            int jc[4];
            float wc0[4], wc1[4];
            int p = o / s, pc = o - p * s;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                jc[e] = p + phase_d(pc, s) + 1 - p0;
                wc0[e] = __ldg(wt + pc);
                wc1[e] = __ldg(wt + s + pc);
                if (++pc == s) { pc = 0; ++p; }
            }
            for (int c = 0; c < C; ++c) {
                const float* a = r0 + c * wpad;
                const float* bb = r1 + c * wpad;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float left = lerp_rn(a[jc[e]], bb[jc[e]], wa, wb);
                    const float right = lerp_rn(a[jc[e] + 1], bb[jc[e] + 1], wa, wb);
                    take(lerp_rn(left, right, wc0[e], wc1[e]), c, best[e], idx[e]);
                }
            }
            store_run(out + ((size_t)b * h * s + (size_t)q0 * s + ry) * Wout + o, idx, o, Wout, vec);
        }
    }
}

// grid: (column tiles, row bands, B); THREADS threads; shared memory
// (bh + 2) * C * wpad floats.
template <bool S2>
__global__ void __launch_bounds__(THREADS)
upsample_argmax_kernel(const float* __restrict__ x, int32_t* __restrict__ out, int h, int w, int C,
                       int s, int bh, int bw, int wpad, const float* __restrict__ wt) {
    extern __shared__ float win[];
    const int b = blockIdx.z;
    const int q0 = blockIdx.y * bh;
    const int p0 = blockIdx.x * bw;
    load_band(win, x + (size_t)b * h * w * C, h, w, C, q0, p0, bh, wpad);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    band_labels<S2>(win, out, b, h, w, C, s, q0, p0, bh, bw, wpad, wt);
}

}  // namespace

// x (B,h,w,C) float32 contiguous, out (B,h*s,w*s) int32 contiguous (16-byte
// aligned).  The plan (bh source rows a band, bw source columns, wpad
// window columns, smem bytes) and the phase table of s come from
// kernels/upsample_argmax.py: wt, (2, s) float32 in device memory, the
// weights 1 - w of the s phases, then w.
extern "C" int upsample_argmax(const void* x, void* out, int B, int h, int w, int C, int s, int bh,
                               int bw, int wpad, int smem, const void* wt, void* stream) {
    if (s < 1 || !wt || C < 1 || bh < 1 || bw < 4 || bw % 4 || wpad < bw + 2 || wpad % 2
        || (long long)smem < (long long)(bh + 2) * C * wpad * 4 || smem > 227 * 1024
        || ((uintptr_t)out) % 16)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((w + bw - 1) / bw, (h + bh - 1) / bh, B);
    cudaStream_t st = (cudaStream_t)stream;
#define UA_LAUNCH(S2)                                                                                     \
    do {                                                                                                  \
        if (smem > 48 * 1024) {                                                                           \
            const cudaError_t e = cudaFuncSetAttribute(upsample_argmax_kernel<S2>,                        \
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
            if (e != cudaSuccess) return (int)e;                                                          \
        }                                                                                                 \
        upsample_argmax_kernel<S2><<<grid, THREADS, smem, st>>>((const float*)x, (int32_t*)out, h, w, C, \
                                                                s, bh, bw, wpad, (const float*)wt);       \
    } while (0)
    if (s == 2) UA_LAUNCH(true);
    else UA_LAUNCH(false);
#undef UA_LAUNCH
    return (int)cudaGetLastError();
}
