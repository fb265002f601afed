// The parity-decomposed training tail: x2 bilinear upsample + softmax +
// class-balanced loss + confusion matrix (T1, parity_tail_fwd) and its
// gradient (T2, parity_tail_bwd), with no full-resolution tensor.
//
// Replaces no Pallas kernel: it is the port's form of the jnp function
// tail_loss_cm (deeplabv3plus_keras_tpu/ops/parity_tail.py:84), which XLA
// fuses on the TPU.  In eager PyTorch every shift, lerp, softmax and log of
// the four parity planes would be its own (B, H, W, C) tensor, and autograd
// would keep them.
//
// The x2 half-pixel upsample along one axis is a 2-tap lerp per output
// parity: up[2k] = 1/4 x[k-1] + 3/4 x[k], up[2k+1] = 3/4 x[k] + 1/4 x[k+1],
// with x[-1] = x[0] and x[n] = x[n-1].  A full-resolution pixel (r, s) is
// the row blend of its parent site's two taps at each of its two tap
// columns, then the column blend of those (the order of the JAX function
// and of ops/parity_tail.py, every product and sum rounded by an _rn
// intrinsic so nvcc contracts nothing: the parity values, and so the
// confusion matrix's argmax, equal the plain float32 version's bit for bit).
//
// Bound: memory.  The least traffic is the logits read once, the labels
// read once and, for T2, dlogits written once; per full-resolution pixel and
// class the work is a lerp, an exp, one or two logs (T1) or two divisions
// (T2), under the card's operations-per-byte balance for one-hot labels.
//
// Design (kernels/parity_tail.py _parity_tail_plan): a block owns TR x TW
// half-resolution sites of one image and stages their logits, with a
// one-site halo clamped at the image's edges (which is the upsample's edge
// clamp), as float32 into shared memory, [row][column][class] with the
// class stride CP = C rounded up to odd so that threads reading one class of
// neighbouring pixels hit distinct banks.
// - T1: a thread per full-resolution pixel of the tile (4 TR TW threads):
//   three passes over C (the maximum and the argmax, the softmax's sum, the
//   loss), the labels read straight from device memory; the per-pixel loss
//   summed by a fixed-order tree to one value per block, written to a
//   (B, blocks) buffer, then a second kernel sums each sample's row in
//   double in a fixed order: bit-reproducible.  The confusion matrix is
//   counted with integer atomics in shared memory (when C*C ints fit in
//   32 KB), then added to the output by integer atomics: exact.
// - T2: phase 1 computes the gradient of every full-resolution pixel that
//   the tile's sites reach (rows 2 i0 - 1 .. 2 (i0 + TR), columns likewise;
//   zero outside the image) into shared memory: four passes over C (the
//   maximum, the sum, p and the dot product sum_c a_c p_c with p kept, then
//   g = scale_b p (a - dot)).  Phase 2: a thread per (site, class), classes
//   fastest so the stores are coalesced: the transposed lerp of the site's
//   4 x 4 pixels, separable as a column pass then a row pass, in a fixed
//   order.  A sample whose scale is 0 (padding) writes zeros.
//
// C interface: parity_tail_fwd(...) and parity_tail_bwd(...) return
// cudaGetLastError() (or cudaErrorInvalidValue for arguments the kernels do
// not take).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUM_THREADS = 256;

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ float load_f(const __half* p, size_t i) { return __half2float(p[i]); }

__device__ __forceinline__ void store_f(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) { p[i] = __float2bfloat16(v); }
__device__ __forceinline__ void store_f(__half* p, size_t i, float v) { p[i] = __float2half(v); }

// Labels: one-hot rows in a float type, or one integer class per pixel.
template <typename L> struct Dense { static constexpr bool value = true; };
template <> struct Dense<int64_t> { static constexpr bool value = false; };
template <> struct Dense<int32_t> { static constexpr bool value = false; };

template <typename L> __device__ __forceinline__ int label_id(const L* p, size_t i) { return (int)p[i]; }

__device__ __forceinline__ float blend(float a, float b, float wa, float wb) {
    return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

// One full-resolution pixel's four window entries and lerp weights.
struct Pixel {
    const float* aa;  // (tap row a, tap column a)
    const float* ab;  // (row a, column b)
    const float* ba;
    const float* bb;
    float wra, wrb, wca, wcb;

    // The pixel (r, s) of a window whose entry (0, 0) is site (i0 - 1, j0 - 1).
    __device__ __forceinline__ Pixel(const float* win, int xc, int cp, int r, int s, int i0, int j0) {
        const int kr = (r >> 1) - i0 + 1, kc = (s >> 1) - j0 + 1;
        const int ra = (r & 1) ? kr : kr - 1, ca = (s & 1) ? kc : kc - 1;
        wra = (r & 1) ? 0.75f : 0.25f;
        wrb = (r & 1) ? 0.25f : 0.75f;
        wca = (s & 1) ? 0.75f : 0.25f;
        wcb = (s & 1) ? 0.25f : 0.75f;
        aa = win + ((size_t)ra * xc + ca) * cp;
        ab = aa + cp;
        ba = aa + (size_t)xc * cp;
        bb = ba + cp;
    }

    // The row blend of each tap column, then the column blend.
    __device__ __forceinline__ float value(int c) const {
        return blend(blend(aa[c], ba[c], wra, wrb), blend(ab[c], bb[c], wra, wrb), wca, wcb);
    }
};

// The label weight y_c of a pixel: its one-hot entry, or 1 at its class.
template <typename L>
__device__ __forceinline__ float label_weight(const L* lab, int c, int t) {
    if constexpr (Dense<L>::value) {
        return load_f(lab, c);
    } else {
        return c == t ? 1.f : 0.f;
    }
}

// dl/dp_c of the class-balanced loss, a term whose label weight is 0 left out.
__device__ __forceinline__ float loss_slope(float p, float y, float pw, float nw, float eps) {
    float a = 0.f;
    if (y != 0.f) a -= pw * y / (p + eps);
    if (y != 1.f) a += nw * (1.f - y) / (1.f - p + eps);
    return a;
}

// Stage rows i0 - 1 .. i0 + TR and columns j0 - 1 .. j0 + TW of image xb
// (each index clamped to the image) as float32 into win.
template <typename T>
__device__ __forceinline__ void load_window(float* win, const T* __restrict__ xb, int H, int W, int C,
                                            int cp, int i0, int j0, int xr, int xc) {
    const int run = xc * C;
    for (int k = 0; k < xr; ++k) {
        const int row = min(max(i0 - 1 + k, 0), H - 1);
        const T* src = xb + (size_t)row * W * C;
        for (int e = threadIdx.x; e < run; e += blockDim.x) {
            const int jj = e / C, c = e - jj * C;
            const int col = min(max(j0 - 1 + jj, 0), W - 1);
            win[((size_t)k * xc + jj) * cp + c] = load_f(src, (size_t)col * C + c);
        }
    }
}

template <typename T, typename L>
__global__ void tail_fwd_kernel(const T* __restrict__ x, const L* __restrict__ label,
                                const float* __restrict__ wts, const int* __restrict__ valid,
                                float* __restrict__ partial, int* __restrict__ cm, int H, int W, int C,
                                int cp, int TR, int TW, int hist_in_smem, float eps) {
    extern __shared__ float smem[];
    const int xr = TR + 2, xc = TW + 2, nt = blockDim.x, t = threadIdx.x;
    float* win = smem;
    float* red = win + (size_t)xr * xc * cp;
    int* hist = reinterpret_cast<int*>(red + nt);
    const int b = blockIdx.z, i0 = blockIdx.y * TR, j0 = blockIdx.x * TW;
    const float* pw = wts;
    const float* nw = wts + C;

    load_window(win, x + (size_t)b * H * W * C, H, W, C, cp, i0, j0, xr, xc);
    if (hist_in_smem)
        for (int e = t; e < C * C; e += nt) hist[e] = 0;
    __syncthreads();

    const bool counted = valid == nullptr || valid[b] != 0;
    const int r = 2 * i0 + t / (2 * TW), s = 2 * j0 + t % (2 * TW);
    float loss = 0.f;
    if (r < 2 * H && s < 2 * W) {
        const Pixel px(win, xc, cp, r, s, i0, j0);
        const size_t pix = ((size_t)b * 2 * H + r) * 2 * W + s;
        const L* lab = Dense<L>::value ? label + pix * C : label + pix;
        const int tl = Dense<L>::value ? 0 : label_id(label, pix);
        float m = px.value(0);
        int pred = 0;
        for (int c = 1; c < C; ++c) {
            const float v = px.value(c);
            if (v > m) {
                m = v;
                pred = c;
            }
        }
        float sum = 0.f;
        for (int c = 0; c < C; ++c) sum += expf(px.value(c) - m);
        float ymax = 0.f;
        int truth = tl;
        for (int c = 0; c < C; ++c) {
            const float p = expf(px.value(c) - m) / sum;
            const float y = label_weight(lab, c, tl);
            if (Dense<L>::value && (c == 0 || y > ymax)) {
                ymax = y;
                truth = c;
            }
            if (y != 0.f) loss += pw[c] * y * logf(p + eps);
            if (y != 1.f) loss += nw[c] * (1.f - y) * logf(1.f - p + eps);
        }
        loss = -loss;
        if (counted && truth >= 0 && truth < C) {
            if (hist_in_smem)
                atomicAdd(hist + truth * C + pred, 1);
            else
                atomicAdd(cm + truth * C + pred, 1);
        }
    }
    red[t] = loss;
    __syncthreads();
    for (int h = nt / 2; h > 0; h >>= 1) {
        if (t < h) red[t] += red[t + h];
        __syncthreads();
    }
    if (t == 0) partial[((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = red[0];
    if (hist_in_smem)
        for (int e = t; e < C * C; e += nt)
            if (hist[e]) atomicAdd(cm + e, hist[e]);
}

// Each sample's block sums, in double, in a fixed order.
__global__ void tail_sum_kernel(const float* __restrict__ partial, int n, float* __restrict__ out) {
    __shared__ double red[SUM_THREADS];
    const float* p = partial + (size_t)blockIdx.x * n;
    double a = 0.0;
    for (int e = threadIdx.x; e < n; e += SUM_THREADS) a += (double)p[e];
    red[threadIdx.x] = a;
    __syncthreads();
    for (int h = SUM_THREADS / 2; h > 0; h >>= 1) {
        if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[blockIdx.x] = (float)red[0];
}

// The weights of full-resolution rows 2i - 1, 2i, 2i + 1, 2i + 2 in the
// gradient of site i along an axis of n sites (the clamps' 1/4 included).
__device__ __forceinline__ void site_weights(int i, int n, float (&w)[4]) {
    w[0] = i >= 1 ? 0.25f : 0.f;
    w[1] = i == 0 ? 1.f : 0.75f;
    w[2] = i == n - 1 ? 1.f : 0.75f;
    w[3] = i + 1 <= n - 1 ? 0.25f : 0.f;
}

template <typename T, typename L>
__global__ void tail_bwd_kernel(const T* __restrict__ x, const L* __restrict__ label,
                                const float* __restrict__ wts, const float* __restrict__ scale,
                                T* __restrict__ dx, int H, int W, int C, int cp, int TR, int TW, float eps) {
    extern __shared__ float smem[];
    const int xr = TR + 2, xc = TW + 2, rr = 2 * TR + 2, rc = 2 * TW + 2;
    const int nt = blockDim.x, t = threadIdx.x;
    float* win = smem;
    float* g = win + (size_t)xr * xc * cp;
    const int b = blockIdx.z, i0 = blockIdx.y * TR, j0 = blockIdx.x * TW;
    const float sc = scale[b];
    const float* pw = wts;
    const float* nw = wts + C;
    T* dxb = dx + (size_t)b * H * W * C;

    if (sc == 0.f) {  // a padded sample: no gradient
        for (int e = t; e < TR * TW * C; e += nt) {
            const int li = e / (TW * C), rem = e - li * TW * C, lj = rem / C, c = rem - lj * C;
            const int i = i0 + li, j = j0 + lj;
            if (i < H && j < W) store_f(dxb, ((size_t)i * W + j) * C + c, 0.f);
        }
        return;
    }
    load_window(win, x + (size_t)b * H * W * C, H, W, C, cp, i0, j0, xr, xc);
    __syncthreads();

    // phase 1: the gradient of each full-resolution pixel the tile reaches
    for (int q = t; q < rr * rc; q += nt) {
        const int a = q / rc, qc = q - a * rc;
        const int r = 2 * i0 - 1 + a, s = 2 * j0 - 1 + qc;
        float* gq = g + (size_t)q * cp;
        if (r < 0 || r >= 2 * H || s < 0 || s >= 2 * W) {
            for (int c = 0; c < C; ++c) gq[c] = 0.f;
            continue;
        }
        const Pixel px(win, xc, cp, r, s, i0, j0);
        const size_t pix = ((size_t)b * 2 * H + r) * 2 * W + s;
        const L* lab = Dense<L>::value ? label + pix * C : label + pix;
        const int tl = Dense<L>::value ? 0 : label_id(label, pix);
        float m = px.value(0);
        for (int c = 1; c < C; ++c) m = fmaxf(m, px.value(c));
        float sum = 0.f;
        for (int c = 0; c < C; ++c) sum += expf(px.value(c) - m);
        float dot = 0.f;
        for (int c = 0; c < C; ++c) {
            const float p = expf(px.value(c) - m) / sum;
            dot += loss_slope(p, label_weight(lab, c, tl), pw[c], nw[c], eps) * p;
            gq[c] = p;
        }
        for (int c = 0; c < C; ++c) {
            const float p = gq[c];
            gq[c] = sc * (p * (loss_slope(p, label_weight(lab, c, tl), pw[c], nw[c], eps) - dot));
        }
    }
    __syncthreads();

    // phase 2: each site's transposed lerp of its 4 x 4 pixels
    for (int e = t; e < TR * TW * C; e += nt) {
        const int li = e / (TW * C), rem = e - li * TW * C, lj = rem / C, c = rem - lj * C;
        const int i = i0 + li, j = j0 + lj;
        if (i >= H || j >= W) continue;
        float wr[4], wc[4];
        site_weights(i, H, wr);
        site_weights(j, W, wc);
        float acc = 0.f;
#pragma unroll
        for (int ra = 0; ra < 4; ++ra) {
            const float* row = g + ((size_t)(2 * li + ra) * rc + 2 * lj) * cp + c;
            float h = 0.f;
#pragma unroll
            for (int cb = 0; cb < 4; ++cb) h += wc[cb] * row[(size_t)cb * cp];
            acc += wr[ra] * h;
        }
        store_f(dxb, ((size_t)i * W + j) * C + c, acc);
    }
}

bool plan_ok(int B, int H, int W, int C, int cp, int TR, int TW, int threads) {
    return B >= 1 && H >= 1 && W >= 1 && C >= 1 && cp >= C && TR >= 1 && TW >= 1 && threads == 4 * TR * TW
           && (threads & (threads - 1)) == 0 && threads <= 1024 && B <= 65535 && (H + TR - 1) / TR <= 65535;
}

template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, typename L>
int launch_fwd(const void* x, const void* label, const void* wts, const void* valid, void* partial, void* sums,
               void* cm, int B, int H, int W, int C, int cp, int TR, int TW, int threads, int smem, int hist,
               float eps, cudaStream_t st) {
    cudaError_t e = allow_smem(tail_fwd_kernel<T, L>, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((W + TW - 1) / TW, (H + TR - 1) / TR, B);
    tail_fwd_kernel<T, L><<<grid, threads, smem, st>>>(
        (const T*)x, (const L*)label, (const float*)wts, (const int*)valid, (float*)partial, (int*)cm, H, W, C, cp,
        TR, TW, hist, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    tail_sum_kernel<<<B, SUM_THREADS, 0, st>>>((const float*)partial, (int)(grid.x * grid.y), (float*)sums);
    return (int)cudaGetLastError();
}

template <typename T, typename L>
int launch_bwd(const void* x, const void* label, const void* wts, const void* scale, void* dx, int B, int H, int W,
               int C, int cp, int TR, int TW, int threads, int smem, float eps, cudaStream_t st) {
    cudaError_t e = allow_smem(tail_bwd_kernel<T, L>, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((W + TW - 1) / TW, (H + TR - 1) / TR, B);
    tail_bwd_kernel<T, L><<<grid, threads, smem, st>>>(
        (const T*)x, (const L*)label, (const float*)wts, (const float*)scale, (T*)dx, H, W, C, cp, TR, TW, eps);
    return (int)cudaGetLastError();
}

// The (logits, labels) instantiation of codes xdt (0 float32, 1 bfloat16,
// 2 float16) and ldt (0-2 those, one-hot; 3 int64, 4 int32).
template <template <typename, typename> class F, typename... A>
int dispatch(int xdt, int ldt, A... args) {
#define PT_LABELS(T)                                        \
    switch (ldt) {                                          \
        case 0: return F<T, float>::run(args...);           \
        case 1: return F<T, __nv_bfloat16>::run(args...);   \
        case 2: return F<T, __half>::run(args...);          \
        case 3: return F<T, int64_t>::run(args...);         \
        case 4: return F<T, int32_t>::run(args...);         \
        default: return (int)cudaErrorInvalidValue;         \
    }
    switch (xdt) {
        case 0: PT_LABELS(float)
        case 1: PT_LABELS(__nv_bfloat16)
        case 2: PT_LABELS(__half)
        default: return (int)cudaErrorInvalidValue;
    }
#undef PT_LABELS
}

template <typename T, typename L> struct Fwd {
    template <typename... A> static int run(A... args) { return launch_fwd<T, L>(args...); }
};
template <typename T, typename L> struct Bwd {
    template <typename... A> static int run(A... args) { return launch_bwd<T, L>(args...); }
};

}  // namespace

extern "C" int parity_tail_fwd(const void* x, int xdt, const void* label, int ldt, const void* wts,
                               const void* valid, void* partial, void* sums, void* cm, int B, int H, int W,
                               int C, int cp, int TR, int TW, int threads, int smem, int hist, float eps,
                               void* stream) {
    const long long need = (long long)(TR + 2) * (TW + 2) * cp * 4 + threads * 4 + (hist ? (long long)C * C * 4 : 0);
    if (!plan_ok(B, H, W, C, cp, TR, TW, threads) || smem < need || smem > 227 * 1024 || !x || !label || !wts
        || !partial || !sums || !cm)
        return (int)cudaErrorInvalidValue;
    return dispatch<Fwd>(xdt, ldt, x, label, wts, valid, partial, sums, cm, B, H, W, C, cp, TR, TW, threads, smem,
                         hist, eps, (cudaStream_t)stream);
}

extern "C" int parity_tail_bwd(const void* x, int xdt, const void* label, int ldt, const void* wts,
                               const void* scale, void* dx, int B, int H, int W, int C, int cp, int TR, int TW,
                               int threads, int smem, float eps, void* stream) {
    const long long need = ((long long)(TR + 2) * (TW + 2) + (long long)(2 * TR + 2) * (2 * TW + 2)) * cp * 4;
    if (!plan_ok(B, H, W, C, cp, TR, TW, threads) || smem < need || smem > 227 * 1024 || !x || !label || !wts
        || !scale || !dx)
        return (int)cudaErrorInvalidValue;
    return dispatch<Bwd>(xdt, ldt, x, label, wts, scale, dx, B, H, W, C, cp, TR, TW, threads, smem, eps,
                         (cudaStream_t)stream);
}
