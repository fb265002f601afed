// Depthwise 3x3 convolution, stride 1, dilation 1, zero ("SAME") padding,
// channels-first: the tensors are NCHW-contiguous, so each (b, c) plane is
// one contiguous H x W array with W the minor axis.  Forward (K6) and
// backward (K7: the input gradient dx and the weight gradient dk).
//
// Replaces the Pallas TPU kernels _dw_fwd_padded
// (deeplabv3plus_keras_tpu/kernels/depthwise3.py:105, body _fwd_kernel :66)
// and _dw_bwd_padded (depthwise3.py:185), which the JAX package runs under
// DLV3_DW_LAYOUT=bhcw on a (B, H, C, W) layout with W on the TPU's lanes.
// The TPU DMA'd an H-halo slab per grid step and shifted it along the
// lanes; dk lived in one output block carried across its sequential grid.
//
// Bound: memory.  The forward does 9 multiply-adds per output for 8 bytes
// moved (float32), the backward 18 for 12: far below the card's
// operations-per-byte balance.  The least time is x read and y written
// once (forward: 2 tensors), or x and g read and dx written (backward: 3),
// over the device memory rate, 3.35 TB/s on the H100.  Accumulation is
// float32 for float32, bfloat16 and float16.
//
// Both are laid out by a plan from the shape alone (kernels/depthwise.py
// _cf_fwd_plan, _cf_bwd_plan), so the output is the same bit for bit from
// run to run.  Both take a tile as whole rows and copy its window (the
// tile and a one-row halo above and below) into shared memory by 16-byte
// cp.async while the block computes on the previous tile (two buffers): a
// block's loads overlap its compute, and no block pays a launch and a
// barrier for a few KB.  Every copy is 16 bytes: each row into a padded
// shared row where W and the pointers allow (LOAD_VEC; a thread then
// computes a strip of 16 bytes of adjacent outputs, one 16-byte window read
// and one vector store a row), else the window's rows as the one contiguous
// run of the plane that they are (LOAD_FLAT, for W = 253 or 127, whose rows
// are not 16-byte aligned, or a misaligned view; the halo is masked).  A
// chunk that crosses either end of the tensor is copied element by
// element, so nothing outside the tensor is read.  A thread slides a window
// of 3 rows in registers down its rows.
//
// - K6, the forward.  The B * C planes are one tall image of B * C * H
//   rows in memory, so a tile of whole rows is one contiguous run.  On
//   small planes (eight 32^2 planes, two 64^2 ones) a tile is several
//   whole consecutive planes of the flattened (b, c) index, one window
//   copy for all of them; the rows of a neighbouring plane above and below
//   each plane are masked to zero, and each strip of rows (within one
//   plane) takes its channel's taps, rounded to the dtype as the plain
//   conv's weight is.  Larger planes are cut into tiles of whole rows.  A
//   block walks `walk` consecutive tiles (about 64 KB of input in LOAD_VEC
//   mode, 2 tiles in LOAD_FLAT), leaving at least two blocks for each of
//   the 132 SMs.  The one-block-a-32x32-tile design it replaces loaded
//   element by element (a division and four bounds checks an element, the
//   same instructions for 2-byte elements as for 4), stored 128 bytes a
//   warp, re-read 13 % of the bytes through its 34 x 34 halo tiles,
//   started every tile row unaligned on the odd planes, and overlapped
//   nothing inside a block.  Here 16-bit tensors move half
//   the bytes with the same copies.  Outputs leave by 16-byte stores: in
//   LOAD_VEC mode one a strip row; in LOAD_FLAT mode a tile's output is one
//   contiguous run of y, which the threads compute by columns as K7 does
//   into a shared copy of the run that is then copied out 16 bytes at a
//   time, ragged ends element by element.  (Each thread computing and
//   storing its own 16-byte chunks of the run took 1.4-2.2x that time on
//   the H100.)
// - K7, the backward.  A block owns one channel and walks `walk` tiles of
//   the flattened (image, tile) index, as the TPU's sequential grid walked
//   its (b, row) tiles: the whole plane at 32^2, half a plane at 64^2, 16
//   rows of the odd 127^2 and 253^2 planes.  dx is the stencil over g with
//   the taps reversed (the JAX _bwd_kernel's decomposition,
//   depthwise3.py:151-160).  dk's nine sums stay in registers across the
//   walk; the block adds them in a fixed order (a tree over the thread
//   index) and writes dk[c], or, where the plan splits a channel's
//   positions among `groups` blocks to fill the card evenly, one row of a
//   (groups, 9, C) buffer that a second kernel adds in a fixed order.  No
//   atomics.
//
// C interface: dw_cf_fwd(...) and dw_cf_bwd(...) return cudaGetLastError()
// after their launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int DK_CH = 32;    // channels of a dk_final block (threadIdx.x)
constexpr int DK_LANES = 8;  // partial lanes of a dk_final block (threadIdx.y)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half(v); }

// Two 16-bit elements packed in 32 bits, to and from two floats.
__device__ __forceinline__ float2 unpack2(uint32_t w, __nv_bfloat16) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
__device__ __forceinline__ float2 unpack2(uint32_t w, __half) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __nv_bfloat16) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __half) {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
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
template <> __device__ __forceinline__ __half zero_t<__half>() { return __float2half(0.f); }

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
        const float2 a = unpack2(u.x, T{});
        const float2 b = unpack2(u.y, T{});
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
        *reinterpret_cast<uint2*>(p) = make_uint2(pack2(o[0], o[1], T{}), pack2(o[2], o[3], T{}));
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

// ---- K6: the forward, as kernels/depthwise.py _cf_fwd_plan lays it out ----

// How a tile's outputs reach y.  LOAD_VEC: thread (tx, ty) computes the
// strip of columns V tx .. V tx + V - 1 (V = 16 bytes of elements) of its
// rows, one 16-byte window read and one 16-byte store a row.  LOAD_FLAT:
// thread tx computes columns tx, tx + ncx, ... of its rows, as K7 does,
// into a shared copy of the tile's output run, which the block then copies
// out 16 bytes at a time.

struct CfFwdGeom {
    CfGeom g;    // the window loaders' view: the B * C planes as one image of g.H = B * C * H rows,
                 // tiles of g.th rows, g.positions tiles in all, g.walk a block
    int H;       // rows of a plane
    int planes;  // whole planes a tile (g.th = planes * H), or 1: g.tiles tiles of g.th rows a plane
};

// Columns j0 - 1 .. j0 + V of a window row into v, p pointing at column j0
// (16-byte aligned: one vector load and two element loads).
template <typename T, int N>
__device__ __forceinline__ void read_strip(const T* p, float (&v)[N]) {
    constexpr int V = 16 / (int)sizeof(T);
    static_assert(N == V + 2, "a strip is 16 bytes and one column on each side");
    if constexpr (sizeof(T) == 4) {
        const float4 f = *reinterpret_cast<const float4*>(p);
        v[1] = f.x; v[2] = f.y; v[3] = f.z; v[4] = f.w;
    } else {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 f = unpack2(w[e], T{});
            v[1 + 2 * e] = f.x;
            v[2 + 2 * e] = f.y;
        }
    }
    v[0] = to_f(p[-1]);
    v[V + 1] = to_f(p[V]);
}

// 16 bytes of outputs at p (16-byte aligned): one vector store.
template <typename T, int N>
__device__ __forceinline__ void store_strip(T* p, const float (&o)[N]) {
    static_assert(N == 16 / sizeof(T), "a strip is 16 bytes");
    if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
        *reinterpret_cast<uint4*>(p) = make_uint4(pack2(o[0], o[1], T{}), pack2(o[2], o[3], T{}),
                                                  pack2(o[4], o[5], T{}), pack2(o[6], o[7], T{}));
    }
}

// v rounded to T's precision, as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
    if constexpr (sizeof(T) == 4) return v;
    else if constexpr (std::is_same<T, __nv_bfloat16>::value) return __bfloat162float(__float2bfloat16(v));
    else return __half2float(__float2half(v));
}

// A row outside the output's plane is zero (a select: the masked values
// may be another plane's, or bytes no copy wrote).
template <int N>
__device__ __forceinline__ void zero_if(bool z, float (&v)[N]) {
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = z ? 0.f : v[e];
}

// o[e] = the 3 x 3 stencil at column e + 1 of rows a (above), b and c
// (below), taps in order t = 3 dy + dx, accumulated in float32.
template <int N>
__device__ __forceinline__ void stencil_rows(const float (&a)[N], const float (&b)[N], const float (&c)[N],
                                             const float (&k)[9], float (&o)[N - 2]) {
#pragma unroll
    for (int e = 0; e < N - 2; ++e) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < 3; ++d) s = fmaf(a[e + d], k[d], s);
#pragma unroll
        for (int d = 0; d < 3; ++d) s = fmaf(b[e + d], k[3 + d], s);
#pragma unroll
        for (int d = 0; d < 3; ++d) s = fmaf(c[e + d], k[6 + d], s);
        o[e] = s;
    }
}

// LOAD_VEC: thread (tx, ty)'s strip over rows q0 .. q0 + nr - 1 of the
// tile whose first row is image row T0; h0 is row q0's row in its plane.
// Window row k (image row T0 - 1 + k) sits at s + k * stride + V.
template <typename T>
__device__ __forceinline__ void fwd_strip_vec(const T* s, T* __restrict__ y, const CfFwdGeom& geo, int T0,
                                              int q0, int nr, int h0, const float (&k)[9]) {
    constexpr int V = 16 / (int)sizeof(T);
    const int W = geo.g.W, S = geo.g.stride;
    const int j0 = V * threadIdx.x;
    const T* sp = s + V + j0 + q0 * S;  // the row above row q0, column j0
    T* yp = y + (size_t)(T0 + q0) * W + j0;
    float a[V + 2], b[V + 2], c[V + 2], o[V];
    read_strip(sp, a);
    zero_if(h0 == 0, a);
    read_strip(sp + S, b);
    for (int rr = 0; rr < nr; ++rr) {
        read_strip(sp + (rr + 2) * S, c);
        zero_if(h0 + rr + 1 == geo.H, c);
        stencil_rows(a, b, c, k, o);
        store_strip(yp + (size_t)rr * W, o);
        shift_rows(a, b, c);
    }
}

// LOAD_FLAT: thread tx's columns over rows q0 .. q0 + nr - 1, from the
// window sp (element (kk, j) at sp[kk * W + j]) into the shared
// run op (tile output (q, j) at op[q * W + j]).
template <typename T>
__device__ __forceinline__ void fwd_cols_flat(const T* sp, T* op, const CfFwdGeom& geo, int q0, int nr, int h0,
                                              const float (&k)[9]) {
    const int W = geo.g.W;
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
        const bool cl = j > 0, cr = j + 1 < W;
        float a[3], b[3], c[3], o[1];
        read3(sp + q0 * W + j, h0 > 0, cl, cr, a);
        read3(sp + (q0 + 1) * W + j, true, cl, cr, b);
        for (int rr = 0; rr < nr; ++rr) {
            read3(sp + (q0 + rr + 2) * W + j, h0 + rr + 1 < geo.H, cl, cr, c);
            stencil_rows(a, b, c, k, o);
            store(op + (q0 + rr) * W + j, o[0]);
            shift_rows(a, b, c);
        }
    }
}

// LOAD_FLAT: the n outputs from yt, out of the shared run ob (whose
// byte 0 stands for the address yt & ~15) by 16-byte chunks, a chunk that
// holds bytes outside the run element by element (they are a
// neighbouring tile's, or outside the tensor).
template <typename T>
__device__ __forceinline__ void copy_out(const T* ob, T* yt, int n, int tid, int nthreads) {
    using U = typename std::conditional<sizeof(T) == 4, uint32_t, uint16_t>::type;
    const uintptr_t ys = (uintptr_t)yt, ye = ys + (uintptr_t)n * sizeof(T), a = ys & ~(uintptr_t)15;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(ob);
    const int chunks = (int)((ye - a + 15) >> 4);
    for (int i = tid; i < chunks; i += nthreads) {
        const uintptr_t d = a + 16 * (uintptr_t)i;
        if (d >= ys && d + 16 <= ye) {
            *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src + 16 * i);
        } else {
            for (int b = 0; b < 16; b += (int)sizeof(T))
                if (d + b >= ys && d + b + sizeof(T) <= ye)
                    *reinterpret_cast<U*>(d + b) = *reinterpret_cast<const U*>(src + 16 * i + b);
        }
    }
}

// grid: (ceil(positions / walk)); block (ncx, nry).  Block b walks tiles
// b * walk ... of the flattened tile index (planes whole planes a tile, or
// tiles a plane) through STAGES windows: the next tile's copies are in
// flight while it computes on the current one.  Each thread's rows of a
// tile lie in one plane, whose channel's taps it loads while the window
// lands.
template <typename T, int MODE>
__global__ void __launch_bounds__(256, 3)
dw_cf_fwd_kernel(const T* __restrict__ x, const float* __restrict__ taps, T* __restrict__ y, const CfFwdGeom geo) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sm = reinterpret_cast<T*>(smem_raw);
    constexpr int PAD = 16 / (int)sizeof(T);
    const CfGeom& g = geo.g;
    const int n0 = blockIdx.x * g.walk;
    const int n1 = min(n0 + g.walk, g.positions);
    const int nthreads = blockDim.x * blockDim.y;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    if constexpr (MODE == LOAD_VEC) {
        // the pad columns before each window row and after the last, which
        // no copy writes: th + 3 chunks of 16 bytes a window
        const int pads = g.th + 3;
        for (int i = tid; i < STAGES * pads; i += nthreads) {
            const int st = i / pads;
            *reinterpret_cast<uint4*>(sm + st * g.buf + (i - st * pads) * g.stride) = make_uint4(0, 0, 0, 0);
        }
        __syncthreads();
    }
    const size_t total = (size_t)g.H * g.W;  // the tensor's ends, which a LOAD_FLAT chunk may cross
    // image row (of the B * C * H) that starts tile n, and the tile's rows
    auto locate = [&](int n, int& T0, int& rows) {
        if (geo.planes > 1) {
            T0 = n * g.th;
            rows = min(g.th, g.H - T0);
        } else {
            const int p = n / g.tiles;
            const int t = n - p * g.tiles;
            T0 = p * geo.H + t * g.th;
            rows = min(g.th, geo.H - t * g.th);
        }
    };
    auto issue = [&](int n, int stage) {
        int T0, rows;
        locate(n, T0, rows);
        T* s = sm + stage * g.buf;
        if constexpr (MODE == LOAD_VEC) load_window_vec<T>(s, x, g, T0);
        else load_window_flat<T>(s, x, g, T0, (uintptr_t)x, (uintptr_t)(x + total), tid, nthreads);
    };
    // one commit group a tile, in walk order (empty past the walk's end);
    // tile n0 + i sits in slot i % STAGES
    issue(n0, 0);
    cp_async_commit();

    const int q0 = threadIdx.y * g.r;  // this thread's first row of a tile
    for (int n = n0; n < n1; ++n) {
        const int i = n - n0;
        const int stage = i % STAGES;
        // the slot of tile n - 1, which every thread has finished with
        if (n + 1 < n1) issue(n + 1, (i + 1) % STAGES);
        cp_async_commit();
        int T0, rows;
        locate(n, T0, rows);
        const int nr = min(g.r, rows - q0);
        const int R0 = T0 + (nr <= 0 ? 0 : q0);
        const int pl = R0 / geo.H;
        const int h0 = R0 - pl * geo.H;
        const int ch = pl % g.C;
        float k[9];  // rounded to T, as the plain conv sees them
#pragma unroll
        for (int t = 0; t < 9; ++t) k[t] = round_to<T>(__ldg(taps + (size_t)t * g.C + ch));
        cp_async_wait_all_but_newest();  // tile n + 1 may fly: tile n has landed
        __syncthreads();
        const T* s = sm + stage * g.buf;
        if constexpr (MODE == LOAD_VEC) {
            if (PAD * (int)threadIdx.x < g.W && nr > 0) fwd_strip_vec<T>(s, y, geo, T0, q0, nr, h0, k);
        } else {
            const T* sp = s + PAD + (int)(flat_first(x, T0, g.W) & 15) / (int)sizeof(T);
            T* yt = y + (size_t)T0 * g.W;
            T* ob = sm + STAGES * g.buf;
            if (nr > 0)
                fwd_cols_flat<T>(sp, ob + (int)((uintptr_t)yt & 15) / (int)sizeof(T), geo, q0, nr, h0, k);
            __syncthreads();
            copy_out<T>(ob, yt, rows * g.W, tid, nthreads);
        }
        __syncthreads();  // before a later copy overwrites this slot (and, flat, the run)
    }
}

bool bad_shape(int dtype, int B, int C, int H, int W) {
    if (dtype < 0 || dtype > 2) return true;
    if (B < 1 || C < 1 || H < 1 || W < 1 || B > 65535 || C > 65535) return true;
    return (long long)B * C * H * W >= 0x80000000LL;  // 32-bit row and element indices
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  x, y (B, C, H, W)
// NCHW-contiguous; taps (9, C) float32, tap t = 3 * dy + dx, which the
// kernel rounds to the dtype (the plain conv's weight).  The rest is
// the plan of kernels/depthwise.py _cf_fwd_plan: mode (LOAD_VEC,
// LOAD_FLAT), block (ncx, nry), r rows a thread, tiles of th = nry * r
// rows (planes whole planes, or tiles a plane), walk tiles a block, smem
// bytes.
extern "C" int dw_cf_fwd(const void* x, const void* taps, void* y, int dtype, int B, int C, int H, int W,
                         int mode, int ncx, int nry, int r, int planes, int tiles, int walk, int smem,
                         void* stream) {
    if (bad_shape(dtype, B, C, H, W) || !x || !taps || !y) return (int)cudaErrorInvalidValue;
    if ((mode != LOAD_VEC && mode != LOAD_FLAT) || ncx < 1 || ncx > 256 || nry < 1 || nry > 256 || r < 1
        || ncx * nry > 256 || planes < 1 || tiles < 1 || walk < 1)
        return (int)cudaErrorInvalidValue;
    const int isz = dtype == 0 ? 4 : 2, pad = 16 / isz;
    if (mode == LOAD_VEC && ((W * isz) % 16 || ((uintptr_t)x | (uintptr_t)y) % 16))
        return (int)cudaErrorMisalignedAddress;
    const long long N = (long long)B * C, th = (long long)nry * r;
    const long long positions = planes > 1 ? (N + planes - 1) / planes : N * tiles;
    const bool covers = planes > 1 ? mode == LOAD_VEC && th == (long long)planes * H && H % r == 0 && tiles == 1
                                   : (long long)tiles * th >= H && (long long)(tiles - 1) * th < H;
    if (!covers || (mode == LOAD_VEC && (long long)ncx * pad < W) || th > N * H
        || positions > 0x7fffffffLL || (positions + walk - 1) / walk > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    CfFwdGeom geo;
    CfGeom& g = geo.g;
    g.C = C; g.H = (int)(N * H); g.W = W;
    g.th = (int)th; g.r = r;
    g.stride = W + pad;
    g.buf = mode == LOAD_VEC ? (g.th + 2) * g.stride + pad : ((g.th + 2) * W + 3 * pad + pad - 1) / pad * pad;
    g.tiles = tiles;
    g.walk = walk; g.positions = (int)positions;
    g.np2 = 0;
    geo.H = H;
    geo.planes = planes;
    const long long out = mode == LOAD_FLAT ? (th * W + 2 * pad - 1) / pad * pad : 0;
    const long long need = ((long long)STAGES * g.buf + out) * isz;
    if ((long long)smem < need || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid((unsigned)((positions + walk - 1) / walk)), block(ncx, nry);
#define CF_FWD_LAUNCH(T, S)                                                                                 \
    do {                                                                                                    \
        if (smem > 48 * 1024) {                                                                             \
            const cudaError_t e = cudaFuncSetAttribute(dw_cf_fwd_kernel<T, S>,                              \
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);  \
            if (e != cudaSuccess) return (int)e;                                                            \
        }                                                                                                   \
        dw_cf_fwd_kernel<T, S><<<grid, block, smem, st>>>((const T*)x, (const float*)taps, (T*)y, geo);     \
    } while (0)
#define CF_FWD_MODES(T)                                                   \
    do {                                                                  \
        if (mode == LOAD_VEC) CF_FWD_LAUNCH(T, LOAD_VEC);                 \
        else CF_FWD_LAUNCH(T, LOAD_FLAT);                                 \
    } while (0)
    if (dtype == 0) CF_FWD_MODES(float);
    else if (dtype == 1) CF_FWD_MODES(__nv_bfloat16);
    else CF_FWD_MODES(__half);
#undef CF_FWD_MODES
#undef CF_FWD_LAUNCH
    return (int)cudaGetLastError();
}

// x, g, dx (B, C, H, W) NCHW-contiguous, x and g of dtype (0 = float32,
// 1 = bfloat16, 2 = float16); dx or null (taps (9, C) float32 read only for dx); dk
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
    else if (dtype == 1 && mode == LOAD_VEC) CF_LAUNCH(__nv_bfloat16, LOAD_VEC);
    else if (dtype == 1) CF_LAUNCH(__nv_bfloat16, LOAD_FLAT);
    else if (mode == LOAD_VEC) CF_LAUNCH(__half, LOAD_VEC);
    else CF_LAUNCH(__half, LOAD_FLAT);
#undef CF_LAUNCH
    if (dk && groups > 1)
        dw_cf_dk_final<<<dim3((C + DK_CH - 1) / DK_CH, 9), dim3(DK_CH, DK_LANES), 0, st>>>(part, dkp, groups, C);
    return (int)cudaGetLastError();
}
