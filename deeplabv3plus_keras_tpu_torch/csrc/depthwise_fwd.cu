// Depthwise k x k convolution forward, NHWC, TF "SAME" zero padding,
// stride 1 (any dilation) or stride 2 (dilation 1); k in {3, 5, 7};
// float32 or bfloat16 in and out, float32 accumulation.
//
// Replaces the Pallas TPU kernels _dw_fwd_nhwc (stride 1,
// deeplabv3plus_keras_tpu/kernels/depthwise3.py:318, body :267) and
// _dw_fwd_s2 (stride 2 over four parity planes, depthwise3.py:684, body
// :630).  The TPU kept a double-buffered halo slab of th + (k-1)*dh rows in
// VMEM and a resident (k*k, 1, C) tap table.  Here the same idea is made
// in Hopper's terms, and the shape of the work comes from a plan computed
// in Python (kernels/depthwise.py _fwd_plan), which this file obeys:
//
// - Variant "tile" (dilation 1, both strides).  A block computes one tile of
//   TH x TW output pixels x CB channels from the tile's input window,
//   ((TH-1)*S + k) x ((TW-1)*S + k) x CB, staged in shared memory.  One
//   thread loads the window with one TMA copy (cp.async.bulk.tensor, a
//   4-D tensor map of x whose box is the window); the copy engine writes
//   zeros wherever the window leaves the tensor, which is the SAME padding,
//   and completes an mbarrier; the copy is in flight while the block loads
//   its taps.  Several blocks on each SM hide one another's copies (a
//   block that walked two row tiles, copying the second window while
//   computing the first, measured within 1 %).  At stride 2 the window's
//   origin is ho0*2 - pad_t, so the (0, 1) pads of an even size fall out
//   of the zero fill.
// - Variant "gather" (stride 1, any dilation).  At the dilated ASPP sites
//   (k-1)*d reaches past the map, so a staged window would be mostly
//   padding.  Each thread gathers its taps straight from global memory with
//   16-byte loads, skipping taps outside the image.
//
// In both, the lanes of a warp take consecutive 16-byte channel vectors
// first (V = 4 float32 or 8 bfloat16 channels; 8 vectors = one 128-byte
// line per pixel), so global accesses are full lines and shared-memory
// reads are conflict-free at both strides.  Each thread computes a strip of
// R = 4 consecutive outputs along W for its vector and slides the k-wide
// window in registers: per kernel row it reads (R-1)*S + k input vectors
// and applies each to every output it reaches, so an output costs
// k*((R-1)*S + k)/R vector reads from shared memory per 4 or 8 channels.
// k = 3 keeps its taps in registers; k = 5 and 7 stage the block's
// k*k x CB taps in shared memory once.  No integer division per element.
//
// A narrow instantiation (V = 1) of the same kernels takes what the vector
// one cannot: C not a multiple of V, or an x or y not 16-byte aligned.  Its
// threads load the window themselves with plain loads.  The plan chooses
// it; there is no other fallback.
//
// Bound: memory.  Each output does k*k multiply-adds for 4 bytes written and
// (stride 1) about 4 bytes read, far below the card's operations-per-byte
// balance, so the least time is (|x| + |y|) bytes over the memory rate.
// The halo re-reads come from L2.
//
// Helpers shared with the backward (depthwise_bwd.cu) live in
// depthwise_common.cuh.
//
// C interface: dw_fwd(...) returns cudaGetLastError() after the launch.

#include "depthwise_common.cuh"

namespace {

constexpr int MAX_THREADS = 256;  // the plan's largest block

// What the plan fixes for one launch; the kernels read it, never change it.
struct Geo {
    int H, W, C, Ho, Wo, dh, dw, pad_t, pad_l;
    int nv;       // channel vectors per block (lanes across channels)
    int strips;   // strips of R outputs per tile row
    int th;       // output rows per tile
    int cblocks;  // channel blocks: blockIdx.x = tile_w * cblocks + cb
};

// grid: (tiles_w * cblocks, row_tiles, B); block nv * strips * th threads:
// thread (r, s, v) computes outputs (ho0 + r, wo0 + s*R .. +R-1) of
// channels c .. c+V-1.
template <typename T, int K, int S, int V>
__global__ void __launch_bounds__(MAX_THREADS)
dw_fwd_tile(const T* __restrict__ x, const float* __restrict__ taps, T* __restrict__ y, Geo g,
            const __grid_constant__ CUtensorMap tmap) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int cbp = g.nv * V;
    const int tw = g.strips * R;
    const int wr_n = (g.th - 1) * S + K;
    const int wc_n = (tw - 1) * S + K;
    const int bb = buf_bytes(wr_n, wc_n, cbp, sizeof(T));
    T* win = (T*)smem;
    uint64_t* bar = (uint64_t*)(smem + bb);       // TMA only
    float* stap = (float*)(smem + bb + 16);       // (k*k, cbp), k > 3 only
    constexpr bool TMA = V * sizeof(T) == 16;     // else the narrow instantiation

    const int v = threadIdx.x % g.nv;
    const int rest = threadIdx.x / g.nv;
    const int s = rest % g.strips;
    const int r = rest / g.strips;
    const int cb = blockIdx.x % g.cblocks;
    const int wo0 = (blockIdx.x / g.cblocks) * tw;
    const int b = blockIdx.z;
    const int c0 = cb * cbp;
    const int c = c0 + v * V;
    const int ix0 = wo0 * S - g.pad_l;
    const int ho0 = blockIdx.y * g.th;
    const int iy0 = ho0 * S - g.pad_t;

    if constexpr (TMA) {
        if (threadIdx.x == 0) {
            mbar_init(bar);
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncthreads();  // every thread may wait on the barrier from here
        // the window is in flight while the taps load
        if (threadIdx.x == 0)
            tma_window(win, &tmap, bar, c0, ix0, iy0, b, wr_n * wc_n * cbp * (int)sizeof(T));
    } else {
        load_window<T>(win, x + (size_t)b * g.H * g.W * g.C, g.H, g.W, g.C, g.nv, g.strips * g.th,
                       iy0, ix0, wr_n, wc_n, c);
    }

    float kr[K == 3 ? 9 * V : 1];
    if constexpr (K == 3) {
#pragma unroll
        for (int t = 0; t < 9; ++t) {
            if (c < g.C) {
                load_taps<V>(taps + (size_t)t * g.C + c, &kr[t * V]);
            } else {
#pragma unroll
                for (int e = 0; e < V; ++e) kr[t * V + e] = 0.f;
            }
        }
    } else {
        for (int i = threadIdx.x; i < K * K * cbp; i += blockDim.x) {
            const int t = i / cbp, ch = c0 + i - t * cbp;  // once per tap, not per output
            stap[i] = ch < g.C ? taps[(size_t)t * g.C + ch] : 0.f;
        }
    }
    if constexpr (TMA) mbar_wait(bar, 0);
    __syncthreads();  // the window (narrow) and the k > 3 taps are written

    float acc[R][V];
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[j][e] = 0.f;
    const T* strip = win + (r * S * wc_n + s * R * S) * cbp + v * V;
    if constexpr (K == 3) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
            float tk[3][V];
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
#pragma unroll
                for (int e = 0; e < V; ++e) tk[kx][e] = kr[(ky * 3 + kx) * V + e];
            const T* row = strip + ky * wc_n * cbp;
            row_taps<3, S, V>([&](int col, float (&xv)[V]) { load_f<T, V>(row + col * cbp, xv); },
                              tk, acc);
        }
    } else {
        // two kernel rows at a time: unrolling all k = 5 or 7 rows holds
        // their loads in registers at once and spills (ptxas, sm_90a),
        // and so, oddly, does one row at a time for float32 k = 7 stride 2
#pragma unroll 2
        for (int ky = 0; ky < K; ++ky) {
            float tk[K][V];
#pragma unroll
            for (int kx = 0; kx < K; ++kx)
#pragma unroll
                for (int e = 0; e < V; ++e) tk[kx][e] = stap[(ky * K + kx) * cbp + v * V + e];
            const T* row = strip + ky * wc_n * cbp;
            row_taps<K, S, V>([&](int col, float (&xv)[V]) { load_f<T, V>(row + col * cbp, xv); },
                              tk, acc);
        }
    }
    const int ho = ho0 + r;
    if (ho < g.Ho && c < g.C) {
        T* yr = y + (((size_t)b * g.Ho + ho) * g.Wo) * g.C + c;
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const int wo = wo0 + s * R + j;
            if (wo < g.Wo) store_f<T, V>(yr + (size_t)wo * g.C, acc[j]);
        }
    }
}

// Stride 1, any dilation.  grid: (tiles_w * cblocks, ceil(Ho / th), B);
// thread (r, s, v) as in dw_fwd_tile; every tap read from global memory,
// skipped where it falls outside the image.
template <typename T, int K, int V>
__global__ void __launch_bounds__(MAX_THREADS)
dw_fwd_gather(const T* __restrict__ x, const float* __restrict__ taps, T* __restrict__ y, Geo g) {
    const int v = threadIdx.x % g.nv;
    const int rest = threadIdx.x / g.nv;
    const int s = rest % g.strips;
    const int r = rest / g.strips;
    const int cb = blockIdx.x % g.cblocks;
    const int tw = g.strips * R;
    const int wo_s = (blockIdx.x / g.cblocks) * tw + s * R;
    const int b = blockIdx.z;
    const int c = cb * g.nv * V + v * V;
    const int ho = blockIdx.y * g.th + r;
    if (ho >= g.Ho || c >= g.C || wo_s >= g.Wo) return;
    const T* xb = x + (size_t)b * g.H * g.W * g.C + c;

    float acc[R][V];
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
        const int iy = ho - g.pad_t + ky * g.dh;
        if (iy < 0 || iy >= g.H) continue;
        const T* xr = xb + (size_t)iy * g.W * g.C;
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
            float tk[V];
            load_taps<V>(taps + (size_t)(ky * K + kx) * g.C + c, tk);
            const int ix0 = wo_s - g.pad_l + kx * g.dw;
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const int ix = ix0 + j;
                if (ix < 0 || ix >= g.W) continue;
                float xv[V];
                load_f<T, V>(xr + (size_t)ix * g.C, xv);
#pragma unroll
                for (int e = 0; e < V; ++e) acc[j][e] = fmaf(xv[e], tk[e], acc[j][e]);
            }
        }
    }
    T* yr = y + (((size_t)b * g.Ho + ho) * g.Wo) * g.C + c;
#pragma unroll
    for (int j = 0; j < R; ++j)
        if (wo_s + j < g.Wo) store_f<T, V>(yr + (size_t)(wo_s + j) * g.C, acc[j]);
}

template <typename T, int K, int S, int V>
int launch_tile(const void* x, const float* taps, void* y, const Geo& g, const CUtensorMap& map,
                dim3 grid, int threads, int smem, cudaStream_t st) {
    auto kern = dw_fwd_tile<T, K, S, V>;
    if (smem > 48 * 1024) {
        // per device, once: a query and an attribute, never a stream operation
        static int set_for[64] = {0};
        int dev = 0;
        cudaGetDevice(&dev);
        if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
        if (set_for[dev] < smem) {
            const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (e != cudaSuccess) return (int)e;
            set_for[dev] = smem;
        }
    }
    kern<<<grid, threads, smem, st>>>((const T*)x, taps, (T*)y, g, map);
    return 0;
}

template <typename T, int K, int V>
int launch_kv(int variant, int stride, const void* x, const float* taps, void* y, const Geo& g,
              const CUtensorMap& map, dim3 grid, int threads, int smem, cudaStream_t st) {
    if (variant == 1) {  // gather: stride 1, no shared memory
        if (stride != 1 || smem != 0) return (int)cudaErrorInvalidValue;
        dw_fwd_gather<T, K, V><<<grid, threads, 0, st>>>((const T*)x, taps, (T*)y, g);
        return 0;
    }
    if (g.dh != 1 || g.dw != 1) return (int)cudaErrorInvalidValue;
    return stride == 1 ? launch_tile<T, K, 1, V>(x, taps, y, g, map, grid, threads, smem, st)
                       : launch_tile<T, K, 2, V>(x, taps, y, g, map, grid, threads, smem, st);
}

template <typename T, int V>
int launch_v(int variant, int k, int stride, const void* x, const float* taps, void* y,
             const Geo& g, const CUtensorMap& map, dim3 grid, int threads, int smem, cudaStream_t st) {
    switch (k) {
        case 3: return launch_kv<T, 3, V>(variant, stride, x, taps, y, g, map, grid, threads, smem, st);
        case 5: return launch_kv<T, 5, V>(variant, stride, x, taps, y, g, map, grid, threads, smem, st);
        case 7: return launch_kv<T, 7, V>(variant, stride, x, taps, y, g, map, grid, threads, smem, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (B,H,W,C), y (B,Ho,Wo,C), taps (k*k,C)
// float32.  The rest is the plan (kernels/depthwise.py _fwd_plan): variant
// 0 = tile, 1 = gather; vec channels per vector (16 bytes' worth, or 1);
// nv vectors x strips x th threads per block; r outputs per thread (must be
// this file's R); cblocks channel blocks; the grid (gx, gy, B) and the
// dynamic shared bytes.
extern "C" int dw_fwd(const void* x, const void* taps, void* y, int dtype,
                      int B, int H, int W, int C, int Ho, int Wo, int k,
                      int stride, int dh, int dw, int pad_t, int pad_l,
                      int variant, int vec, int nv, int r, int strips, int th,
                      int cblocks, int gx, int gy, int smem,
                      void* stream) {
    const int itemsize = dtype == 0 ? 4 : 2;
    const int threads = nv * strips * th;
    if ((stride != 1 && stride != 2) || (dtype != 0 && dtype != 1) || variant < 0 || variant > 1)
        return (int)cudaErrorInvalidValue;
    if (r != R || threads < 1 || threads > MAX_THREADS || cblocks < 1 || B > 65535)
        return (int)cudaErrorInvalidValue;
    if (vec != 1) {
        if (vec * itemsize != 16 || C % vec || (((uintptr_t)x | (uintptr_t)y) & 15))
            return (int)cudaErrorInvalidValue;
    }
    if (variant == 0) {
        const int need = buf_bytes((th - 1) * stride + k, (strips * R - 1) * stride + k, nv * vec, itemsize)
                         + 16 + (k > 3 ? k * k * nv * vec * 4 : 0);
        if (smem != need) return (int)cudaErrorInvalidValue;
    }
    Geo g{H, W, C, Ho, Wo, dh, dw, pad_t, pad_l, nv, strips, th, cblocks};
    CUtensorMap map{};
    if (variant == 0 && vec != 1) {  // the vector tile loads its windows by TMA
        const int rc = window_map(&map, x, dtype, B, H, W, C, nv * vec, (strips * R - 1) * stride + k,
                                  (th - 1) * stride + k);
        if (rc) return rc;
    }
    const dim3 grid(gx, gy, B);
    cudaStream_t st = (cudaStream_t)stream;
    const float* t = (const float*)taps;
    int rc;
    if (dtype == 0)
        rc = vec == 1 ? launch_v<float, 1>(variant, k, stride, x, t, y, g, map, grid, threads, smem, st)
                      : launch_v<float, 4>(variant, k, stride, x, t, y, g, map, grid, threads, smem, st);
    else
        rc = vec == 1 ? launch_v<__nv_bfloat16, 1>(variant, k, stride, x, t, y, g, map, grid, threads, smem, st)
                      : launch_v<__nv_bfloat16, 8>(variant, k, stride, x, t, y, g, map, grid, threads, smem, st);
    if (rc) return rc;
    return (int)cudaGetLastError();
}
