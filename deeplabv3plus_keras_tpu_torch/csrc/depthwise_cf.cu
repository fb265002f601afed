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
// - K6, the forward: one block per (32 x 32 output tile, channel, image):
//   it loads the 34 x 34 halo tile of its plane into shared memory (zero
//   outside the image, which is the padding), keeps the nine taps in
//   registers, and each thread computes 4 rows of one column, sliding a
//   3 x 3 window of registers down the column.  Every tap is bounds-checked
//   by the tile load, so odd H and W (253, 127) work.  Bound: x read and y
//   written once over the device memory rate; it reaches about half of it.
// - K7, the backward (dx and dk), is laid out by kernels/depthwise.py
//   _cf_bwd_plan.  A block owns one channel and walks `walk` tiles of the
//   flattened (image, tile) index, as the TPU's sequential grid walked its
//   (b, row) tiles.  A tile is whole rows: the whole plane at 32^2, half a
//   plane at 64^2, 16 rows of the odd 127^2 and 253^2 planes.  While it
//   computes on one tile's x and g windows in shared memory, the copies of
//   the next tile are in flight (two buffers, cp.async), so a block's loads
//   overlap its compute, and no block pays a launch, a tile load and a
//   reduction for 12 KB.  Every copy is 16 bytes: each row into a padded
//   shared row where W and the pointers allow (LOAD_VEC; a thread then
//   computes a strip of 4 adjacent outputs, one 16-byte window read and
//   one vector store a row), else the window's rows as the one contiguous
//   run of the plane that they are (LOAD_FLAT, for W = 253 or 127, whose
//   rows are not 16-byte aligned; neighbouring threads then take
//   neighbouring columns and the halo is masked).  A
//   thread slides a window of 3 rows in registers down its rows.  dx is the
//   stencil over g with the taps reversed (the JAX _bwd_kernel's
//   decomposition, depthwise3.py:151-160).  dk's nine sums stay in
//   registers across the walk; the block adds them in a fixed order (a
//   tree over the thread index) and writes dk[c], or, where the plan splits
//   a channel's positions among `groups` blocks to fill the card evenly,
//   one row of a (groups, 9, C) buffer that a second kernel adds in a fixed
//   order.  No atomics, and the plan depends on the shape alone, so dk is
//   the same bit for bit from run to run.
//
// Bound: memory.  The forward does 9 multiply-adds per output for 8 bytes
// moved (float32), the backward 18 for 12: far below the card's
// operations-per-byte balance.  The least time is x read and y written
// (forward: 2 tensors), or x and g read and dx written (backward: 3), over
// the device memory rate.  A tile's halo rows are read again by its
// neighbour, mostly from L2.  Accumulation is float32 for float32 and
// bfloat16.
//
// C interface: dw_cf_fwd(...) and dw_cf_bwd(...) return cudaGetLastError()
// after their launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---- K7: the backward, as kernels/depthwise.py _cf_bwd_plan lays it out ----

// How a window reaches shared memory.  A tile is always whole rows.
// LOAD_VEC: each row by 16-byte cp.async into a row of stride W + PAD
// whose zero pad columns are the halo (W a multiple of the vector, x, g
// and dx 16-byte aligned).  LOAD_FLAT: the window's rows that lie in the
// image are one contiguous run of the plane, copied as the 16-byte chunks
// that hold it, whatever W and the pointers' alignment (W = 253 and 127,
// whose rows are not 16-byte aligned); the compute masks the halo.
enum { LOAD_VEC = 0, LOAD_FLAT = 1 };
constexpr int STAGES = 2;  // x and g window pairs: the current tile's and the next one's

struct CfGeom {
    int C, H, W;
    int th, r;            // tile rows (the tile is whole rows); rows a thread computes
    int stride, buf;      // shared row stride (LOAD_VEC) and one window buffer, in elements
    int tiles;            // tiles of a plane
    int walk, positions;  // tiles a block walks; B * tiles
    int np2;              // threads a block, rounded up to a power of two
};

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// src_size 0 reads nothing and fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most this thread's newest copy group is still in flight.
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename T> __device__ __forceinline__ T zero_t();
template <> __device__ __forceinline__ float zero_t<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_t<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// LOAD_VEC: the window of the tile whose first row is h0: window row k is
// image row h0 - 1 + k at s + k * stride + PAD (zero outside the image);
// only columns [0, W) are copied, so the zero pad columns before a row and
// after the last are the halo.
template <typename T>
__device__ __forceinline__ void load_window_vec(T* s, const T* __restrict__ plane, const CfGeom& g, int h0) {
    constexpr int PAD = 16 / (int)sizeof(T);
    for (int k = threadIdx.y; k < g.th + 2; k += blockDim.y) {
        const int h = h0 - 1 + k;
        const bool hin = h >= 0 && h < g.H;
        const T* row = plane + (size_t)(hin ? h : 0) * g.W;
        T* srow = s + k * g.stride + PAD;
        for (int v = threadIdx.x * PAD; v < g.W; v += blockDim.x * PAD) cp_async16(srow + v, row + v, hin);
    }
}

// LOAD_FLAT: the address of window element (0, 0), image row h0 - 1 (maybe
// before the plane); window rows [k_lo, k_hi) lie in the image.
template <typename T>
__device__ __forceinline__ uintptr_t flat_first(const T* plane, int h0, int W) {
    return (uintptr_t)plane + (uintptr_t)((long long)(h0 - 1) * W * (long long)sizeof(T));
}
__device__ __forceinline__ int flat_k_lo(int h0) { return h0 == 0 ? 1 : 0; }
__device__ __forceinline__ int flat_k_hi(const CfGeom& g, int h0) { return min(g.th + 2, g.H + 1 - h0); }

// LOAD_FLAT: the window's rows in the image, as the 16-byte chunks that
// hold them.  The byte at address a lands at byte 16 + a - (first & ~15)
// of s, so window element (k, j) sits at element PAD + lead + k * W + j,
// lead = (first & 15) / sizeof(T).  A chunk's bytes outside the rows
// belong to the neighbouring rows or planes and are never used.  A chunk
// that crosses either end of the tensor [lo, hi) is copied element by
// element with plain loads, its elements inside the tensor alone, so no
// byte outside the tensor is read (its storage may end there); the
// barrier after the walk's wait publishes those stores.
template <typename T>
__device__ __forceinline__ void load_window_flat(T* s, const T* __restrict__ plane, const CfGeom& g, int h0,
                                                 uintptr_t lo, uintptr_t hi, int tid, int nthreads) {
    using U = typename std::conditional<sizeof(T) == 4, uint32_t, uint16_t>::type;
    const uintptr_t first = flat_first(plane, h0, g.W);
    const uintptr_t row_bytes = (uintptr_t)g.W * sizeof(T);
    const uintptr_t a = (first + flat_k_lo(h0) * row_bytes) & ~(uintptr_t)15;
    const uintptr_t e = (first + flat_k_hi(g, h0) * row_bytes + 15) & ~(uintptr_t)15;
    unsigned char* dst = reinterpret_cast<unsigned char*>(s) + 16 + (a - (first & ~(uintptr_t)15));
    const int chunks = (int)((e - a) >> 4);
    for (int i = tid; i < chunks; i += nthreads) {
        const uintptr_t src = a + 16 * (uintptr_t)i;
        if (src >= lo && src + 16 <= hi) {
            cp_async16(dst + 16 * i, reinterpret_cast<const void*>(src), true);
        } else {
            for (int b = 0; b < 16; b += (int)sizeof(T))
                if (src + b >= lo && src + b + sizeof(T) <= hi)
                    *reinterpret_cast<U*>(dst + 16 * i + b) = *reinterpret_cast<const U*>(src + b);
        }
    }
}

// LOAD_VEC: columns j0 - 1 .. j0 + 4 of a window row, p pointing at column
// j0 (a multiple of 4 elements from the 16-byte aligned row start).
template <typename T>
__device__ __forceinline__ void read6(const T* p, float (&v)[6]) {
    if constexpr (sizeof(T) == 4) {
        const float4 f = *reinterpret_cast<const float4*>(p);
        v[1] = f.x; v[2] = f.y; v[3] = f.z; v[4] = f.w;
    } else {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        v[1] = a.x; v[2] = a.y; v[3] = b.x; v[4] = b.y;
    }
    v[0] = to_f(p[-1]);
    v[5] = to_f(p[4]);
}

// LOAD_FLAT: columns j - 1 .. j + 1 of a window row, p pointing at column
// j; zero for a row outside the image (in) and outside columns [0, W).
template <typename T>
__device__ __forceinline__ void read3(const T* p, bool in, bool cl, bool cr, float (&v)[3]) {
    v[0] = in && cl ? to_f(p[-1]) : 0.f;
    v[1] = in ? to_f(p[0]) : 0.f;
    v[2] = in && cr ? to_f(p[1]) : 0.f;
}

// Four adjacent outputs of one image row from column j: one vector store.
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&o)[4]) {
    if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
        const __nv_bfloat162 a = __floats2bfloat162_rn(o[0], o[1]);
        const __nv_bfloat162 b = __floats2bfloat162_rn(o[2], o[3]);
        *reinterpret_cast<uint2*>(p) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
    }
}

// One output row's share of a thread, from the 3-row windows of x and g
// around it (xa, ga the row above, xc, gc the row below; N columns, the
// outputs being columns 1 .. N - 2): the nine dk sums of x[shifted] * g
// (when dk) and dx, the stencil over g with the taps reversed (the JAX
// _bwd_kernel's decomposition, depthwise3.py:151-160), into o.
template <int N>
__device__ __forceinline__ void row_grads(const float (&xa)[N], const float (&xb)[N], const float (&xc)[N],
                                          const float (&ga)[N], const float (&gb)[N], const float (&gc)[N],
                                          const float (&k)[9], float (&acc)[9], bool want_dk,
                                          float (&o)[N - 2]) {
    if (want_dk) {
#pragma unroll
        for (int e = 0; e < N - 2; ++e) {
            const float gv = gb[e + 1];
#pragma unroll
            for (int d = 0; d < 3; ++d) {
                acc[d] = fmaf(xa[e + d], gv, acc[d]);
                acc[3 + d] = fmaf(xb[e + d], gv, acc[3 + d]);
                acc[6 + d] = fmaf(xc[e + d], gv, acc[6 + d]);
            }
        }
    }
#pragma unroll
    for (int e = 0; e < N - 2; ++e) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < 3; ++d) s = fmaf(ga[e + d], k[8 - d], s);
#pragma unroll
        for (int d = 0; d < 3; ++d) s = fmaf(gb[e + d], k[5 - d], s);
#pragma unroll
        for (int d = 0; d < 3; ++d) s = fmaf(gc[e + d], k[2 - d], s);
        o[e] = s;
    }
}

template <int N>
__device__ __forceinline__ void shift_rows(float (&a)[N], float (&b)[N], const float (&c)[N]) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
        a[e] = b[e];
        b[e] = c[e];
    }
}

// grid: (C, groups); block (ncx, nry).  Block (c, y) walks tiles y * walk
// ... of the flattened (image, tile) index of channel c through STAGES
// pairs of x and g windows: the next tile's copies are in flight while it
// computes on the current one.  A tile is th whole
// rows; thread (tx, ty) computes its rows ty * r .. ty * r + r - 1 at the
// columns 4 tx .. 4 tx + 3 (LOAD_VEC: one 16-byte window read a row, one
// vector store) or tx, tx + ncx, ... (LOAD_FLAT: neighbouring threads on
// neighbouring columns, since a row's alignment in shared memory varies),
// sliding a 3-row window of registers down.  dk's nine sums stay in
// registers across the walk; then the block adds its threads' sums in a
// fixed order and writes dk[c] (one group) or partial row y.
template <typename T, int MODE>
__global__ void __launch_bounds__(256, MODE == LOAD_VEC ? 2 : 3)
dw_cf_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ taps,
                 T* __restrict__ dx, float* __restrict__ dk, float* __restrict__ partial, const CfGeom geo) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sm = reinterpret_cast<T*>(smem_raw);
    constexpr int PAD = 16 / (int)sizeof(T);
    const int c = blockIdx.x;
    const int n0 = blockIdx.y * geo.walk;
    const int n1 = min(n0 + geo.walk, geo.positions);
    const int nthreads = blockDim.x * blockDim.y;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const bool want_dx = dx != nullptr, want_dk = dk != nullptr;
    if constexpr (MODE == LOAD_VEC) {  // the pad columns, which no copy writes
        for (int i = tid; i < 2 * STAGES * geo.buf; i += nthreads) sm[i] = zero_t<T>();
        __syncthreads();
    }
    // the tensors' ends, which a LOAD_FLAT chunk may cross
    const size_t total = (size_t)(geo.positions / geo.tiles) * geo.C * geo.H * geo.W;

    float k[9], acc[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
        k[t] = want_dx ? taps[t * geo.C + c] : 0.f;
        acc[t] = 0.f;
    }
    const size_t plane = (size_t)geo.H * geo.W;
    // (offset of the tile's plane, first row) of position n
    auto locate = [&](int n, size_t& off, int& h0) {
        const int b = n / geo.tiles;
        off = ((size_t)b * geo.C + c) * plane;
        h0 = (n - b * geo.tiles) * geo.th;
    };
    auto issue = [&](int n, int stage) {
        size_t off;
        int h0;
        locate(n, off, h0);
        T* sx = sm + (2 * stage) * geo.buf;
        if constexpr (MODE == LOAD_VEC) {
            load_window_vec<T>(sx, x + off, geo, h0);
            load_window_vec<T>(sx + geo.buf, g + off, geo, h0);
        } else {
            load_window_flat<T>(sx, x + off, geo, h0, (uintptr_t)x, (uintptr_t)(x + total), tid, nthreads);
            load_window_flat<T>(sx + geo.buf, g + off, geo, h0, (uintptr_t)g, (uintptr_t)(g + total), tid,
                                nthreads);
        }
    };
    // one commit group a tile, in walk order (empty past the walk's end);
    // tile n0 + i sits in slot i % STAGES
    issue(n0, 0);
    cp_async_commit();

    const int r0 = threadIdx.y * geo.r;
    const int W = geo.W;
    for (int n = n0; n < n1; ++n) {
        const int i = n - n0;
        const int stage = i % STAGES;
        // the slot of tile n - 1, which every thread has finished with
        if (n + 1 < n1) issue(n + 1, (i + 1) % STAGES);
        cp_async_commit();
        cp_async_wait_all_but_newest();  // tile n + 1 may fly: tile n has landed
        __syncthreads();
        size_t off;
        int h0;
        locate(n, off, h0);
        T* dxp = want_dx ? dx + off : nullptr;
        if constexpr (MODE == LOAD_VEC) {
            const int j0 = 4 * threadIdx.x;
            const int S = geo.stride;
            if (j0 < W) {
                const T* sx = sm + (2 * stage) * geo.buf + PAD + j0;
                const T* sg = sx + geo.buf;
                float xa[6], xb[6], ga[6], gb[6];
                read6(sx + r0 * S, xa);
                read6(sx + (r0 + 1) * S, xb);
                read6(sg + r0 * S, ga);
                read6(sg + (r0 + 1) * S, gb);
                for (int rr = 0; rr < geo.r; ++rr) {
                    // output row h0 + r0 + rr is window row r0 + rr + 1; g outside
                    // the image is 0, so such rows add nothing to dk
                    float xc[6], gc[6], o[4];
                    read6(sx + (r0 + rr + 2) * S, xc);
                    read6(sg + (r0 + rr + 2) * S, gc);
                    row_grads<6>(xa, xb, xc, ga, gb, gc, k, acc, want_dk, o);
                    const int h = h0 + r0 + rr;
                    if (want_dx && h < geo.H) store4(dxp + (size_t)h * W + j0, o);
                    shift_rows<6>(xa, xb, xc);
                    shift_rows<6>(ga, gb, gc);
                }
            }
        } else {
            const int k_lo = flat_k_lo(h0), k_hi = flat_k_hi(geo, h0);
            const T* sx = sm + (2 * stage) * geo.buf + PAD + (int)(flat_first(x + off, h0, W) & 15) / (int)sizeof(T);
            const T* sg = sm + (2 * stage + 1) * geo.buf + PAD + (int)(flat_first(g + off, h0, W) & 15) / (int)sizeof(T);
            for (int j = threadIdx.x; j < W; j += blockDim.x) {
                const bool cl = j > 0, cr = j + 1 < W;
                float xa[3], xb[3], ga[3], gb[3];
                read3(sx + r0 * W + j, r0 >= k_lo && r0 < k_hi, cl, cr, xa);
                read3(sx + (r0 + 1) * W + j, r0 + 1 >= k_lo && r0 + 1 < k_hi, cl, cr, xb);
                read3(sg + r0 * W + j, r0 >= k_lo && r0 < k_hi, cl, cr, ga);
                read3(sg + (r0 + 1) * W + j, r0 + 1 >= k_lo && r0 + 1 < k_hi, cl, cr, gb);
                for (int rr = 0; rr < geo.r; ++rr) {
                    const int kc = r0 + rr + 2;
                    const bool in = kc >= k_lo && kc < k_hi;
                    float xc[3], gc[3], o[1];
                    read3(sx + kc * W + j, in, cl, cr, xc);
                    read3(sg + kc * W + j, in, cl, cr, gc);
                    row_grads<3>(xa, xb, xc, ga, gb, gc, k, acc, want_dk, o);
                    const int h = h0 + r0 + rr;
                    if (want_dx && h < geo.H) store(dxp + (size_t)h * W + j, o[0]);
                    shift_rows<3>(xa, xb, xc);
                    shift_rows<3>(ga, gb, gc);
                }
            }
        }
        __syncthreads();  // before a later copy overwrites this slot
    }

    if (want_dk) {
        // the walk's copies have all landed: the windows become a (9, np2)
        // table of the threads' sums, added as a tree over the thread index
        float* red = reinterpret_cast<float*>(smem_raw);
        const int np2 = geo.np2;
#pragma unroll
        for (int t = 0; t < 9; ++t) red[t * np2 + tid] = acc[t];
        for (int i = nthreads + tid; i < np2; i += nthreads)
#pragma unroll
            for (int t = 0; t < 9; ++t) red[t * np2 + i] = 0.f;
        __syncthreads();
        for (int half = np2 / 2; half > 0; half >>= 1) {
            if (tid < half)
#pragma unroll
                for (int t = 0; t < 9; ++t) red[t * np2 + tid] += red[t * np2 + tid + half];
            __syncthreads();
        }
        // a block of small planes may have fewer than 9 threads
        for (int t = tid; t < 9; t += nthreads) {
            if (gridDim.y == 1) dk[(size_t)c * 9 + t] = red[t * np2];
            else partial[((size_t)blockIdx.y * 9 + t) * geo.C + c] = red[t * np2];
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

bool bad_shape(int dtype, int B, int C, int H, int W) {
    if (dtype != 0 && dtype != 1) return true;
    if (B < 1 || C < 1 || H < 1 || W < 1 || B > 65535 || C > 65535) return true;
    const long long tiles = (long long)((H + TH - 1) / TH) * ((W + TW - 1) / TW);
    return tiles > 0x7fffffffLL;
}

}  // namespace

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

// x, g, dx (B, C, H, W) NCHW-contiguous, x and g of dtype (0 = float32,
// 1 = bfloat16); dx or null (taps (9, C) float32 read only for dx); dk
// (C, 9) float32 or null, with partial (groups, 9, C) float32 scratch when
// groups > 1.  The rest is the plan of kernels/depthwise.py _cf_bwd_plan:
// mode (LOAD_VEC, LOAD_FLAT), block (ncx, nry), r rows a thread, tiles of
// th = nry * r whole rows a plane, walk tiles a block, groups blocks a
// channel, smem bytes.
extern "C" int dw_cf_bwd(const void* x, const void* g, const void* taps, void* dx, void* dk,
                         void* partial, int dtype, int B, int C, int H, int W, int mode, int ncx,
                         int nry, int r, int tiles, int walk, int groups, int smem, void* stream) {
    if (bad_shape(dtype, B, C, H, W) || (!dx && !dk) || (dx && !taps)) return (int)cudaErrorInvalidValue;
    if (mode != LOAD_VEC && mode != LOAD_FLAT) return (int)cudaErrorInvalidValue;
    const int isz = dtype == 0 ? 4 : 2, pad = 16 / isz;
    if (mode == LOAD_VEC && ((W * isz) % 16 || ((uintptr_t)x | (uintptr_t)g | (uintptr_t)dx) % 16))
        return (int)cudaErrorMisalignedAddress;
    CfGeom geo;
    geo.C = C; geo.H = H; geo.W = W;
    geo.th = nry * r; geo.r = r;
    geo.stride = W + pad;
    geo.buf = mode == LOAD_VEC ? (geo.th + 2) * geo.stride + pad
                               : ((geo.th + 2) * W + 3 * pad + pad - 1) / pad * pad;
    geo.tiles = tiles;
    geo.walk = walk; geo.positions = B * tiles;
    const int threads = ncx * nry;
    geo.np2 = 1;
    while (geo.np2 < threads) geo.np2 *= 2;
    const long long windows = 2LL * STAGES * geo.buf * isz;
    const long long need = windows > 9LL * geo.np2 * 4 ? windows : 9LL * geo.np2 * 4;
    if (ncx < 1 || nry < 1 || r < 1 || threads > 256
        || (mode == LOAD_VEC && 4 * ncx < W) || (long long)tiles * geo.th < H || walk < 1 || groups < 1
        || groups > 65535 || (long long)groups * walk < geo.positions || (long long)(groups - 1) * walk >= geo.positions
        || (long long)smem < need || smem > 227 * 1024 || (dk && groups > 1 && !partial))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid(C, groups), block(ncx, nry);
    float* dkp = (float*)dk;
    float* part = (float*)partial;
#define CF_LAUNCH(T, M)                                                                                   \
    do {                                                                                                  \
        if (smem > 48 * 1024) {                                                                           \
            const cudaError_t e = cudaFuncSetAttribute(dw_cf_bwd_kernel<T, M>,                            \
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem); \
            if (e != cudaSuccess) return (int)e;                                                          \
        }                                                                                                 \
        dw_cf_bwd_kernel<T, M><<<grid, block, smem, st>>>((const T*)x, (const T*)g, (const float*)taps,  \
                                                          (T*)dx, dkp, part, geo);                        \
    } while (0)
    if (dtype == 0 && mode == LOAD_VEC) CF_LAUNCH(float, LOAD_VEC);
    else if (dtype == 0) CF_LAUNCH(float, LOAD_FLAT);
    else if (mode == LOAD_VEC) CF_LAUNCH(__nv_bfloat16, LOAD_VEC);
    else CF_LAUNCH(__nv_bfloat16, LOAD_FLAT);
#undef CF_LAUNCH
    if (dk && groups > 1)
        dw_cf_dk_final<<<dim3((C + DK_CH - 1) / DK_CH, 9), dim3(DK_CH, DK_LANES), 0, st>>>(part, dkp, groups, C);
    return (int)cudaGetLastError();
}
