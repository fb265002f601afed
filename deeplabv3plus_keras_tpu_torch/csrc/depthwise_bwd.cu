// Depthwise k x k convolution backward, NHWC, TF "SAME" zero padding,
// stride 1 (any dilation) or stride 2 (dilation 1); k in {3, 5, 7}; x, g
// and dx float32 or bfloat16, float32 accumulation: the input gradient dx
// and the weight gradient dk of depthwise_fwd.cu's forward.
//
// Replaces the Pallas TPU kernels _dw_bwd_nhwc (stride 1,
// deeplabv3plus_keras_tpu/kernels/depthwise3.py:422, body :346) and
// _dw_bwd_s2 (stride 2 over four parity planes, depthwise3.py:798, body
// :719).  The TPU staged one x slab and one g slab per row tile and
// computed both gradients from them: dx as the stencil over g with the taps
// reversed, dk as the sum of x shifted by each tap times g, carried in one
// output block across its sequential grid.  Here the same fusion is made in
// Hopper's terms, laid out by a plan computed in Python
// (kernels/depthwise.py _bwd_plan), which this file obeys:
//
// - Variant "tile" (dilation 1, both strides).  A block owns a column of
//   tiles of TH x TW outputs x CB channels and walks `walk` of them (row
//   tiles of the flattened (image, tile row) index), so that its dk partial
//   covers enough of the map.  For each tile one thread stages two windows
//   in shared memory by TMA, each on its own mbarrier: the tile's x window
//   (K3's window, ((TH-1)*S + k) x ((TW-1)*S + k)) and the g window that the
//   tile's dx pixels gather from (the g tile plus a halo of k-1 at stride 1,
//   plus (k-1)/2 rows and columns before it at stride 2).  The copy engine
//   writes zeros outside the tensors, which is the SAME padding of both
//   gradients, so the inner loops check no bounds.  Where two sets of
//   windows fit in 96 KB (the plan's `stages`), the next tile's windows are
//   copied while the block computes on the current ones: a walk leaves few
//   blocks on each SM to hide one another's copies.
//   - dx: at stride 1 the dx tile is the output tile, and dx is the
//     forward's register strip (row_taps) over the g window with the taps
//     reversed.  At stride 2 the dx tile is the 2TH x 2TW input pixels
//     from (2*ho0 - pad_t, 2*wo0 - pad_l), so the tiles partition the
//     input; dx pixel (rho, gamma) of the tile takes g window pixel
//     ((rho + ky')/2, (gamma + kx')/2) through reversed tap (ky', kx')
//     where both sums are even: each dx row and column takes only the taps
//     of its parity, the TPU's parity planes without the split and merge.
//     A thread computes dx rows 2r and 2r+1, 2R columns each, one row of
//     taps live at a time.
//   - dk: k = 3 keeps 9*V float32 sums per thread over its R outputs and
//     every tile the block walks (the window slides in registers as for
//     dx); after the walk the block adds its threads' sums in a fixed order
//     in one shared-memory pass and writes one (9, CB) row of the partial
//     buffer.  k = 5 and 7 (whose k*k*V sums would not fit in registers)
//     give each thread whole (tap, channel vector) entries instead, each
//     summed over a tile's outputs in registers and added to its running
//     sum in shared memory, in a fixed order: no reduction across threads.
// - Variant "gather" (stride 1, dilated).  At the dilated ASPP sites
//   (k-1)*d reaches past the map, so a staged window would be mostly
//   padding.  dx is K2's gather over g with the taps reversed, dk the same
//   per-thread sums from 16-byte x and g loads; taps outside the image are
//   skipped.  Half the block's threads compute dx and half dk, over the
//   same strips: its loads wait on L2, and the walk leaves few blocks.
// - A final kernel sums the partial rows of every block in a fixed order.
//   No float atomics anywhere, so dk is the same bit for bit from run to run.
//
// Lanes take consecutive 16-byte channel vectors first (V = 4 float32 or 8
// bfloat16 channels), so every global access is a full 128-byte line per
// pixel and shared-memory reads are conflict-free.  k = 3 float32 keeps its
// taps in registers; bfloat16 and k = 5, 7 read them from shared memory.
// A narrow instantiation (V = 1) takes what the vector one cannot (C not a
// multiple of V, or a pointer not 16-byte aligned): its threads load the
// windows themselves.  The plan chooses it; there is no other fallback.
//
// Bound: memory.  dx does k*k (stride 1) or about k*k/4 (stride 2)
// multiply-adds per element written, dk k*k per output element: far below
// the card's operations-per-byte balance.  The least time is x and g read
// once and dx written once; here each crosses device memory once, plus the
// halo re-reads from L2 and a partial buffer of about 1.6 % of x.
//
// C interface: dw_bwd(...) launches the fused kernel (dx when dx is not
// null, dk's partials when dk is not null) and, for dk, the final sum, and
// returns cudaGetLastError().

#include "depthwise_common.cuh"

namespace {

constexpr int MAX_THREADS = 256;  // the plan's largest block
constexpr int DK_CH = 32;         // channels of a final-pass block (threadIdx.x)
constexpr int DK_LANES = 32;      // partial rows summed side by side (threadIdx.y)

// What the plan fixes for one launch; the kernels read it, never change it.
struct BGeo {
    int B, H, W, C, Ho, Wo, dh, dw, pad_t, pad_l;
    int nv;       // channel vectors per block
    int strips;   // strips of R outputs per tile row
    int th;       // output rows per tile
    int cblocks;  // channel blocks: blockIdx.x = tile_w * cblocks + cb
    int tiles_w;  // tiles along W
    int nty;      // row tiles per image
    int walk;     // row tiles a block walks: blockIdx.y * walk + i of B * nty
    int stages;   // window buffers (tile variant): 2 copies the next tile's
                  // windows while the block computes on the current ones
    int want_dx, want_dk;
};

// Registers or shared memory for the dx taps, and the dk scheme.
template <int K, int V> constexpr bool REG_TAPS = K == 3 && V <= 4;
template <int K> constexpr bool STRIP_DK = K == 3;

// Shared bytes the kernels need (the plan computes the same): `stages`
// buffers of the two windows, or the reduction buffer of the per-thread dk
// sums that overlays them after the walk (k = 3), whichever is larger; two
// barriers a buffer; the taps when they live in shared memory; the (tap,
// vector) entries' sums (k > 3).  The gather variant has only the reduction
// buffer or the entries.
int bwd_smem(int variant, int k, int stride, int vec, int nv, int strips, int th, int stages,
             int itemsize) {
    const int cbp = nv * vec, tw = strips * R, threads = nv * strips * th;  // dk threads
    const int red = k == 3 ? ((threads * (k * k * vec + 1) * 4 + 127) & ~127) : 0;
    const int ent = k == 3 ? 0 : k * k * cbp * 4;
    if (variant == 1) return red + ent;
    const int p = (k - 1) / 2;
    const int xw = buf_bytes((th - 1) * stride + k, (tw - 1) * stride + k, cbp, itemsize);
    const int gw = stride == 1 ? buf_bytes(th + k - 1, tw + k - 1, cbp, itemsize)
                               : buf_bytes(th + p, tw + p, cbp, itemsize);
    const bool reg_taps = k == 3 && vec <= 4;
    const int bufs = stages * (xw + gw);
    return (bufs > red ? bufs : red) + 16 * stages + (reg_taps ? 0 : k * k * cbp * 4) + ent;
}

// acc[d] += one row of reversed taps tk applied to g, stride 2: g column
// wc of the strip reaches dx column d through tap kx' = 2*wc - d, so each
// of the R/2 + (K-1)/2 columns is read once and used by every dx column it
// reaches.
template <int K, int V, typename Load>
__device__ __forceinline__ void row_taps_up2(Load load, const float (&tk)[K][V], float (&acc)[R][V]) {
#pragma unroll
    for (int wc = 0; wc < R / 2 + (K - 1) / 2; ++wc) {
        float gv[V];
        load(wc, gv);
#pragma unroll
        for (int d = 0; d < R; ++d) {
            const int kx = 2 * wc - d;  // compile-time
            if (kx >= 0 && kx < K) {
#pragma unroll
                for (int e = 0; e < V; ++e) acc[d][e] = fmaf(gv[e], tk[kx][e], acc[d][e]);
            }
        }
    }
}

// dk sums of one strip of R outputs from the windows: xs is the x window at
// the strip's first tap (row r*S, column s*R*S), gs the g window at its
// first output.  Per kernel row the (R-1)*S + K x columns are read once.
template <typename T, int K, int S, int V>
__device__ __forceinline__ void dk_strip(const T* xs, const T* gs, int xc_n, int cbp, float (&dks)[K * K][V]) {
    float gv[R][V];
#pragma unroll
    for (int j = 0; j < R; ++j) load_f<T, V>(gs + j * cbp, gv[j]);
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
        const T* row = xs + ky * xc_n * cbp;
#pragma unroll
        for (int col = 0; col < (R - 1) * S + K; ++col) {
            float xv[V];
            load_f<T, V>(row + col * cbp, xv);
#pragma unroll
            for (int kx = 0; kx < K; ++kx) {
                const int d = col - kx;
                if (d >= 0 && d % S == 0 && d / S < R) {
#pragma unroll
                    for (int e = 0; e < V; ++e) dks[ky * K + kx][e] = fmaf(xv[e], gv[d / S][e], dks[ky * K + kx][e]);
                }
            }
        }
    }
}

// After the walk: the block's per-thread dk sums into one (K*K, CB) row of
// the partial buffer (out = partial + slot*K*K*C), channel by channel in the
// order of the dk threads (tid = (row * strips + strip) * nv + vector; the
// writers), through red (which may overlay the windows).  Every thread of
// the block calls it.
template <int KK, int V>
__device__ __forceinline__ void reduce_strips(float* red, const float (&dks)[KK][V], float* out,
                                              int C, int c0, int cbp, int nv, int nrs, int tid,
                                              bool writer) {
    constexpr int ST = KK * V + 1;  // odd: the writes below are conflict-free
    __syncthreads();                // the windows are no longer read
    if (writer) {
#pragma unroll
        for (int t = 0; t < KK; ++t)
#pragma unroll
            for (int e = 0; e < V; ++e) red[tid * ST + t * V + e] = dks[t][e];
    }
    __syncthreads();
    for (int q = threadIdx.x; q < KK * cbp; q += blockDim.x) {
        const int t = q / cbp, ch = q - t * cbp;  // once per entry, not per output
        const int vv = ch / V, e = ch - vv * V;
        float s = 0.f;
        for (int i = 0; i < nrs; ++i) s += red[(i * nv + vv) * ST + t * V + e];
        if (c0 + ch < C) out[(size_t)t * C + c0 + ch] = s;
    }
}

// k > 3: the running sums sent[q*V ..] of the (tap, vector) entries q the
// thread owns (q = tid, tid + n, ... for n dk threads) into the partial row out.
template <int K, int V>
__device__ __forceinline__ void write_entries(const float* sent, float* out, int C, int c0, int nv,
                                              int tid, int n) {
    for (int q = tid; q < K * K * nv; q += n) {
        const int t = q / nv, vv = q - t * nv;
#pragma unroll
        for (int e = 0; e < V; ++e)
            if (c0 + vv * V + e < C) out[(size_t)t * C + c0 + vv * V + e] = sent[q * V + e];
    }
}

// Add a (tap, vector) entry's sum over one tile to its running sum.
template <int V>
__device__ __forceinline__ void add_entry(float* se, const float (&a)[V], bool first) {
#pragma unroll
    for (int e = 0; e < V; ++e) se[e] = first ? a[e] : se[e] + a[e];
}

// Stage the windows of flattened row tile rt (image b, first output row
// ho0) into the buffer at buf (x window, then the g window xbb bytes on):
// one thread issues the TMA copies onto bar[0] and bar[1], or (narrow) every
// thread loads its share.  The x window only when dk is wanted.
template <typename T, int K, int S, bool TMA>
__device__ __forceinline__ void stage_windows(unsigned char* buf, int xbb, uint64_t* bar,
                                              const CUtensorMap* xm, const CUtensorMap* gm,
                                              const T* __restrict__ x, const T* __restrict__ gy,
                                              const BGeo& g, int rt, int wo0, int c0, int c, int cbp,
                                              int threads) {
    constexpr int P = (K - 1) / 2;
    const int tw = g.strips * R;
    const int xr_n = (g.th - 1) * S + K, xc_n = (tw - 1) * S + K;
    const int gr_n = S == 1 ? g.th + K - 1 : g.th + P;
    const int gc_n = S == 1 ? tw + K - 1 : tw + P;
    T* xw = (T*)buf;
    T* gw = (T*)(buf + xbb);
    const int b = rt / g.nty;
    const int ho0 = (rt - b * g.nty) * g.th;
    const int gy0 = S == 1 ? ho0 + g.pad_t - (K - 1) : ho0 - P;
    const int gx0 = S == 1 ? wo0 + g.pad_l - (K - 1) : wo0 - P;
    if constexpr (TMA) {
        if (threadIdx.x == 0) {
            if (g.want_dk)
                tma_window(xw, xm, &bar[0], c0, wo0 * S - g.pad_l, ho0 * S - g.pad_t, b,
                           xr_n * xc_n * cbp * (int)sizeof(T));
            tma_window(gw, gm, &bar[1], c0, gx0, gy0, b, gr_n * gc_n * cbp * (int)sizeof(T));
        }
    } else {
        const int step = threads / g.nv;
        if (g.want_dk)
            load_window<T>(xw, x + (size_t)b * g.H * g.W * g.C, g.H, g.W, g.C, g.nv, step,
                           ho0 * S - g.pad_t, wo0 * S - g.pad_l, xr_n, xc_n, c);
        load_window<T>(gw, gy + (size_t)b * g.Ho * g.Wo * g.C, g.Ho, g.Wo, g.C, g.nv, step,
                       gy0, gx0, gr_n, gc_n, c);
    }
}

// grid: (tiles_w * cblocks, ceil(B * nty / walk)); block nv * strips * th
// threads: thread (r, s, v) owns outputs (ho0 + r, wo0 + s*R .. +R-1) of
// channels c .. c+V-1 for dk, and the dx pixels described at the top.
template <typename T, int K, int S, int V>
__global__ void __launch_bounds__(MAX_THREADS)
dw_bwd_tile(const T* __restrict__ x, const T* __restrict__ gy, const float* __restrict__ taps,
            T* __restrict__ dx, float* __restrict__ partial, BGeo g,
            const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap) {
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr int P = (K - 1) / 2;
    constexpr bool TMA = V * sizeof(T) == 16;  // else the narrow instantiation
    const int cbp = g.nv * V;
    const int tw = g.strips * R;
    const int xr_n = (g.th - 1) * S + K, xc_n = (tw - 1) * S + K;
    const int gr_n = S == 1 ? g.th + K - 1 : g.th + P;
    const int gc_n = S == 1 ? tw + K - 1 : tw + P;
    const int xbb = buf_bytes(xr_n, xc_n, cbp, sizeof(T));
    const int gbb = buf_bytes(gr_n, gc_n, cbp, sizeof(T));
    const int threads = blockDim.x;
    const int redb = STRIP_DK<K> ? ((threads * (K * K * V + 1) * 4 + 127) & ~127) : 0;
    const int bufs = g.stages * (xbb + gbb);
    const int area = bufs > redb ? bufs : redb;
    // buffer i: x window at smem + i*(xbb + gbb), g window xbb after it;
    // bar[2i] and bar[2i+1] complete when they land (TMA only)
    uint64_t* bar = (uint64_t*)(smem + area);
    float* stap = (float*)(smem + area + 16 * g.stages);  // (k*k, cbp) reversed taps, !REG_TAPS only
    float* sent = stap + (REG_TAPS<K, V> ? 0 : K * K * cbp);  // (k*k*nv, V) entry sums, k > 3 only

    const int v = threadIdx.x % g.nv;
    const int rest = threadIdx.x / g.nv;
    const int s = rest % g.strips;
    const int r = rest / g.strips;
    const int cb = blockIdx.x % g.cblocks;
    const int twi = blockIdx.x / g.cblocks;
    const int wo0 = twi * tw;
    const int c0 = cb * cbp;
    const int c = c0 + v * V;
    const int rt0 = blockIdx.y * g.walk;
    const int rt1 = min(rt0 + g.walk, g.B * g.nty);

    if constexpr (TMA) {
        if (threadIdx.x == 0) {
            for (int i = 0; i < 2 * g.stages; ++i) mbar_init(&bar[i]);
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncthreads();  // every thread may wait on the barriers from here
        // the first windows are in flight while the taps load
        stage_windows<T, K, S, TMA>(smem, xbb, bar, &xmap, &gmap, x, gy, g, rt0, wo0, c0, c, cbp, threads);
    }

    float kr[REG_TAPS<K, V> ? K * K * V : 1];  // reversed: kr[t'] = tap k*k-1-t'
    if (g.want_dx) {
        if constexpr (REG_TAPS<K, V>) {
#pragma unroll
            for (int t = 0; t < K * K; ++t) {
                if (c < g.C) {
                    load_taps<V>(taps + (size_t)(K * K - 1 - t) * g.C + c, &kr[t * V]);
                } else {
#pragma unroll
                    for (int e = 0; e < V; ++e) kr[t * V + e] = 0.f;
                }
            }
        } else {
            for (int i = threadIdx.x; i < K * K * cbp; i += threads) {
                const int t = i / cbp, ch = c0 + i - t * cbp;  // once per tap, not per output
                stap[i] = ch < g.C ? taps[(size_t)(K * K - 1 - t) * g.C + ch] : 0.f;
            }
        }
    }
    if constexpr (!REG_TAPS<K, V>) __syncthreads();  // the shared taps are written
    // one row ky' of reversed taps
    auto tap_row = [&](int kyr, float (&tk)[K][V]) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx)
#pragma unroll
            for (int e = 0; e < V; ++e) {
                if constexpr (REG_TAPS<K, V>) tk[kx][e] = kr[(kyr * K + kx) * V + e];
                else tk[kx][e] = stap[(kyr * K + kx) * cbp + v * V + e];
            }
    };

    float dks[STRIP_DK<K> ? K * K : 1][V];
#pragma unroll
    for (int t = 0; t < (STRIP_DK<K> ? K * K : 1); ++t)
#pragma unroll
        for (int e = 0; e < V; ++e) dks[t][e] = 0.f;

    for (int rt = rt0, it = 0; rt < rt1; ++rt, ++it) {
        const int b = rt / g.nty;
        const int ho0 = (rt - b * g.nty) * g.th;
        const int buf = g.stages == 2 ? it & 1 : 0;
        if constexpr (TMA) {
            if (it > 0) __syncthreads();  // every thread is done with the last tile's windows
            if (g.stages == 2 && rt + 1 < rt1)  // lands while this tile computes
                stage_windows<T, K, S, TMA>(smem + (buf ^ 1) * (xbb + gbb), xbb, &bar[2 * (buf ^ 1)], &xmap,
                                            &gmap, x, gy, g, rt + 1, wo0, c0, c, cbp, threads);
            else if (g.stages == 1 && it > 0)
                stage_windows<T, K, S, TMA>(smem, xbb, bar, &xmap, &gmap, x, gy, g, rt, wo0, c0, c, cbp, threads);
            const int parity = (g.stages == 2 ? it >> 1 : it) & 1;
            if (g.want_dk) mbar_wait(&bar[2 * buf], parity);
            mbar_wait(&bar[2 * buf + 1], parity);
        } else {
            if (it > 0) __syncthreads();
            stage_windows<T, K, S, TMA>(smem, xbb, bar, &xmap, &gmap, x, gy, g, rt, wo0, c0, c, cbp, threads);
            __syncthreads();
        }
        const T* xw = (const T*)(smem + buf * (xbb + gbb));
        const T* gw = (const T*)(smem + buf * (xbb + gbb) + xbb);

        if (g.want_dx) {
            if constexpr (S == 1) {
                float acc[R][V];
#pragma unroll
                for (int j = 0; j < R; ++j)
#pragma unroll
                    for (int e = 0; e < V; ++e) acc[j][e] = 0.f;
                const T* strip = gw + (r * gc_n + s * R) * cbp + v * V;
#pragma unroll (K == 3 ? 3 : 2)
                for (int ky = 0; ky < K; ++ky) {
                    float tk[K][V];
                    tap_row(ky, tk);
                    const T* row = strip + ky * gc_n * cbp;
                    row_taps<K, 1, V>([&](int col, float (&gv)[V]) { load_f<T, V>(row + col * cbp, gv); },
                                      tk, acc);
                }
                const int i = ho0 + r;
                if (i < g.H && c < g.C) {
                    T* dr = dx + (((size_t)b * g.H + i) * g.W) * g.C + c;
#pragma unroll
                    for (int j = 0; j < R; ++j) {
                        const int jx = wo0 + s * R + j;
                        if (jx < g.W) store_f<T, V>(dr + (size_t)jx * g.C, acc[j]);
                    }
                }
            } else {
#pragma unroll (REG_TAPS<K, V> ? 2 : 1)  // unrolled, float32 k = 5 stride 2 spills (ptxas, sm_90a)
                for (int a = 0; a < 2; ++a) {  // dx rows 2r and 2r+1 of the tile
                    // both halves of R columns at once, so that one row of
                    // taps is live at a time
                    float acc[2][R][V];
#pragma unroll
                    for (int h = 0; h < 2; ++h)
#pragma unroll
                        for (int j = 0; j < R; ++j)
#pragma unroll
                            for (int e = 0; e < V; ++e) acc[h][j][e] = 0.f;
                    // unrolled where the taps are registers (their index must
                    // be known at compile time); a loop otherwise, so that
                    // the next rows' taps are not loaded ahead
#pragma unroll (REG_TAPS<K, V> ? P + 1 : 1)
                    for (int u = 0; u <= P; ++u) {
                        const int kyr = 2 * u - a;  // the taps of this row's parity
                        if (kyr < 0 || kyr >= K) continue;
                        float tk[K][V];
                        tap_row(kyr, tk);
                        const T* grow = gw + ((r + u) * gc_n + s * R) * cbp + v * V;
#pragma unroll
                        for (int h = 0; h < 2; ++h)
                            row_taps_up2<K, V>(
                                [&](int wc, float (&gv)[V]) { load_f<T, V>(grow + (h * (R / 2) + wc) * cbp, gv); },
                                tk, acc[h]);
                    }
                    const int i = 2 * ho0 - g.pad_t + 2 * r + a;
                    if (i >= 0 && i < g.H && c < g.C) {
                        T* dr = dx + (((size_t)b * g.H + i) * g.W) * g.C + c;
                        const int j0 = 2 * wo0 - g.pad_l + 2 * s * R;
#pragma unroll
                        for (int d = 0; d < 2 * R; ++d) {
                            const int jx = j0 + d;
                            if (jx >= 0 && jx < g.W) store_f<T, V>(dr + (size_t)jx * g.C, acc[d / R][d % R]);
                        }
                    }
                }
            }
        }

        if (g.want_dk) {
            if constexpr (STRIP_DK<K>) {
                dk_strip<T, K, S, V>(xw + (r * S * xc_n + s * R * S) * cbp + v * V,
                                     gw + ((r + P) * gc_n + s * R + P) * cbp + v * V, xc_n, cbp, dks);
            } else {
                for (int q = threadIdx.x; q < K * K * g.nv; q += threads) {
                    const int t = q / g.nv, vv = q - t * g.nv;
                    const int ky = t / K, kx = t - ky * K;
                    const T* xp = xw + (ky * xc_n + kx) * cbp + vv * V;
                    const T* gp = gw + (P * gc_n + P) * cbp + vv * V;
                    float a[V];
#pragma unroll
                    for (int e = 0; e < V; ++e) a[e] = 0.f;
                    for (int rr = 0; rr < g.th; ++rr) {
                        for (int cc = 0; cc < tw; ++cc) {
                            float xv[V], gv[V];
                            load_f<T, V>(xp + (rr * S * xc_n + cc * S) * cbp, xv);
                            load_f<T, V>(gp + (rr * gc_n + cc) * cbp, gv);
#pragma unroll
                            for (int e = 0; e < V; ++e) a[e] = fmaf(xv[e], gv[e], a[e]);
                        }
                    }
                    add_entry<V>(sent + q * V, a, it == 0);
                }
            }
        }
    }

    if (g.want_dk) {
        float* out = partial + ((size_t)blockIdx.y * g.tiles_w + twi) * K * K * g.C;
        if constexpr (STRIP_DK<K>)
            reduce_strips<K * K, V>((float*)smem, dks, out, g.C, c0, cbp, g.nv, g.strips * g.th,
                                    threadIdx.x, true);
        else
            write_entries<K, V>(sent, out, g.C, c0, g.nv, threadIdx.x, threads);
    }
}

// Stride 1, any dilation.  grid as dw_bwd_tile; 2 * nv * strips * th
// threads in two roles over the same strips: thread (role, r, s, v) computes
// dx (role 0) or dk's sums (role 1) of outputs (ho0 + r, wo0 + s*R ..).
// Every tap is read from global memory, skipped where it falls outside the
// image or the map.  The block is few (its dk partial row covers a whole
// walk) and its loads wait on L2, so two roles halve each thread's work.
template <typename T, int K, int V>
__global__ void __launch_bounds__(MAX_THREADS, V <= 4 ? 2 : 1)  // float32: two blocks an SM
dw_bwd_gather(const T* __restrict__ x, const T* __restrict__ gy, const float* __restrict__ taps,
              T* __restrict__ dx, float* __restrict__ partial, BGeo g) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int cbp = g.nv * V;
    const int tw = g.strips * R;
    const int lanes = blockDim.x / 2;  // threads of one role
    const int role = threadIdx.x >= lanes;
    const int tid = threadIdx.x - role * lanes;
    const int v = tid % g.nv;
    const int rest = tid / g.nv;
    const int s = rest % g.strips;
    const int r = rest / g.strips;
    const int cb = blockIdx.x % g.cblocks;
    const int twi = blockIdx.x / g.cblocks;
    const int wo0 = twi * tw;
    const int wo_s = wo0 + s * R;
    const int c0 = cb * cbp;
    const int c = c0 + v * V;
    const int rt0 = blockIdx.y * g.walk;
    const int rt1 = min(rt0 + g.walk, g.B * g.nty);
    const int pad_b = (K - 1) * g.dh - g.pad_t;  // stride 1: the pads sum to (k-1)*d
    const int pad_r = (K - 1) * g.dw - g.pad_l;
    float* sent = (float*)smem;  // (k*k*nv, V) entry sums, k > 3 only

    float dks[STRIP_DK<K> ? K * K : 1][V];
#pragma unroll
    for (int t = 0; t < (STRIP_DK<K> ? K * K : 1); ++t)
#pragma unroll
        for (int e = 0; e < V; ++e) dks[t][e] = 0.f;

    for (int rt = rt0; rt < rt1; ++rt) {
        const int b = rt / g.nty;
        const int ho0 = (rt - b * g.nty) * g.th;
        const int ho = ho0 + r;
        const bool mine = ho < g.Ho && c < g.C && wo_s < g.Wo;
        const T* xb = x + (size_t)b * g.H * g.W * g.C + c;
        const T* gb = gy + (size_t)b * g.Ho * g.Wo * g.C + c;

        if (role == 0) {
            if (g.want_dx && mine) {  // K2's gather over g, taps reversed, pads swapped
                // half a strip at a time: a whole strip's loads in flight
                // at once outgrow the registers of two blocks an SM
#pragma unroll 1
                for (int j0 = 0; j0 < R; j0 += R / 2) {
                    float acc[R / 2][V];
#pragma unroll
                    for (int j = 0; j < R / 2; ++j)
#pragma unroll
                        for (int e = 0; e < V; ++e) acc[j][e] = 0.f;
#pragma unroll (K == 3 ? 3 : 1)
                    for (int ky = 0; ky < K; ++ky) {
                        const int oy = ho - pad_b + ky * g.dh;
                        if (oy < 0 || oy >= g.Ho) continue;
                        const T* gr = gb + (size_t)oy * g.Wo * g.C;
#pragma unroll (K == 3 ? 3 : 1)
                        for (int kx = 0; kx < K; ++kx) {
                            float tk[V];
                            load_taps<V>(taps + (size_t)(K * K - 1 - (ky * K + kx)) * g.C + c, tk);
                            const int ox0 = wo_s + j0 - pad_r + kx * g.dw;
#pragma unroll
                            for (int j = 0; j < R / 2; ++j) {
                                const int ox = ox0 + j;
                                if (ox < 0 || ox >= g.Wo) continue;
                                float gv[V];
                                load_f<T, V>(gr + (size_t)ox * g.C, gv);
#pragma unroll
                                for (int e = 0; e < V; ++e) acc[j][e] = fmaf(gv[e], tk[e], acc[j][e]);
                            }
                        }
                    }
                    T* dr = dx + (((size_t)b * g.H + ho) * g.W) * g.C + c;
#pragma unroll
                    for (int j = 0; j < R / 2; ++j)
                        if (wo_s + j0 + j < g.W) store_f<T, V>(dr + (size_t)(wo_s + j0 + j) * g.C, acc[j]);
                }
            }
        } else if (g.want_dk) {
            if constexpr (STRIP_DK<K>) {
                // half a strip at a time, as dx
#pragma unroll 1
                for (int j0 = 0; mine && j0 < R; j0 += R / 2) {
                    float gv[R / 2][V];
#pragma unroll
                    for (int j = 0; j < R / 2; ++j) {
                        if (wo_s + j0 + j < g.Wo) {
                            load_f<T, V>(gb + ((size_t)ho * g.Wo + wo_s + j0 + j) * g.C, gv[j]);
                        } else {
#pragma unroll
                            for (int e = 0; e < V; ++e) gv[j][e] = 0.f;
                        }
                    }
#pragma unroll
                    for (int ky = 0; ky < K; ++ky) {
                        const int iy = ho - g.pad_t + ky * g.dh;
                        if (iy < 0 || iy >= g.H) continue;
                        const T* xr = xb + (size_t)iy * g.W * g.C;
#pragma unroll
                        for (int kx = 0; kx < K; ++kx) {
                            const int ix0 = wo_s + j0 - g.pad_l + kx * g.dw;
#pragma unroll
                            for (int j = 0; j < R / 2; ++j) {
                                const int ix = ix0 + j;
                                if (ix < 0 || ix >= g.W) continue;
                                float xv[V];
                                load_f<T, V>(xr + (size_t)ix * g.C, xv);
#pragma unroll
                                for (int e = 0; e < V; ++e)
                                    dks[ky * K + kx][e] = fmaf(xv[e], gv[j][e], dks[ky * K + kx][e]);
                            }
                        }
                    }
                }
            } else {
                for (int q = tid; q < K * K * g.nv; q += lanes) {
                    const int t = q / g.nv, vv = q - t * g.nv;
                    const int ky = t / K, kx = t - ky * K;
                    const int ce = c0 + vv * V;
                    float a[V];
#pragma unroll
                    for (int e = 0; e < V; ++e) a[e] = 0.f;
                    const T* xe = x + (size_t)b * g.H * g.W * g.C + ce;
                    const T* ge = gy + (size_t)b * g.Ho * g.Wo * g.C + ce;
                    for (int rr = 0; ce < g.C && rr < g.th; ++rr) {
                        const int hh = ho0 + rr;
                        const int iy = hh - g.pad_t + ky * g.dh;
                        if (hh >= g.Ho || iy < 0 || iy >= g.H) continue;
                        for (int cc = 0; cc < tw; ++cc) {
                            const int ww = wo0 + cc;
                            const int ix = ww - g.pad_l + kx * g.dw;
                            if (ww >= g.Wo || ix < 0 || ix >= g.W) continue;
                            float xv[V], gv[V];
                            load_f<T, V>(xe + ((size_t)iy * g.W + ix) * g.C, xv);
                            load_f<T, V>(ge + ((size_t)hh * g.Wo + ww) * g.C, gv);
#pragma unroll
                            for (int e = 0; e < V; ++e) a[e] = fmaf(xv[e], gv[e], a[e]);
                        }
                    }
                    add_entry<V>(sent + q * V, a, rt == rt0);
                }
            }
        }
    }

    if (g.want_dk) {
        float* out = partial + ((size_t)blockIdx.y * g.tiles_w + twi) * K * K * g.C;
        if constexpr (STRIP_DK<K>)
            reduce_strips<K * K, V>((float*)smem, dks, out, g.C, c0, cbp, g.nv, g.strips * g.th, tid,
                                    role == 1);
        else if (role == 1)
            write_entries<K, V>(sent, out, g.C, c0, g.nv, tid, lanes);
    }
}

// grid: (ceil(C / DK_CH), KK); block (DK_CH, DK_LANES).  dk[c, t] = the sum
// of partial[:, t, c] over the n rows: lane y sums rows y, y + DK_LANES, ...
// in order, then lane 0 adds the lanes in order.  dk is (C, KK) float, the
// (C, 1, k, k) weight layout.
__global__ void dw_bwd_dk_final(const float* __restrict__ partial, float* __restrict__ dk,
                                int n, int KK, int C) {
    __shared__ float red[DK_LANES][DK_CH];
    const int c = blockIdx.x * DK_CH + threadIdx.x;
    const int t = blockIdx.y;
    const int lane = threadIdx.y;
    float s = 0.f;
    if (c < C) {
        const float* p = partial + (size_t)t * C + c;
#pragma unroll 8
        for (int i = lane; i < n; i += DK_LANES) s += p[(size_t)i * KK * C];
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

template <typename T, int K, int S, int V>
int launch_tile(const void* x, const void* g, const float* taps, void* dx, float* partial, const BGeo& geo,
                const CUtensorMap& xmap, const CUtensorMap& gmap, dim3 grid, int threads, int smem,
                cudaStream_t st) {
    auto kern = dw_bwd_tile<T, K, S, V>;
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
    kern<<<grid, threads, smem, st>>>((const T*)x, (const T*)g, taps, (T*)dx, partial, geo, xmap, gmap);
    return 0;
}

template <typename T, int K, int V>
int launch_kv(int variant, int stride, const void* x, const void* g, const float* taps, void* dx,
              float* partial, const BGeo& geo, const CUtensorMap& xmap, const CUtensorMap& gmap,
              dim3 grid, int threads, int smem, cudaStream_t st) {
    if (variant == 1) {  // gather: stride 1, the reduction buffer only (< 48 KB)
        if (stride != 1) return (int)cudaErrorInvalidValue;
        dw_bwd_gather<T, K, V><<<grid, threads, smem, st>>>((const T*)x, (const T*)g, taps, (T*)dx,
                                                            partial, geo);
        return 0;
    }
    return stride == 1
        ? launch_tile<T, K, 1, V>(x, g, taps, dx, partial, geo, xmap, gmap, grid, threads, smem, st)
        : launch_tile<T, K, 2, V>(x, g, taps, dx, partial, geo, xmap, gmap, grid, threads, smem, st);
}

template <typename T, int V>
int launch_v(int variant, int k, int stride, const void* x, const void* g, const float* taps, void* dx,
             float* partial, const BGeo& geo, const CUtensorMap& xmap, const CUtensorMap& gmap,
             dim3 grid, int threads, int smem, cudaStream_t st) {
    switch (k) {
        case 3: return launch_kv<T, 3, V>(variant, stride, x, g, taps, dx, partial, geo, xmap, gmap, grid, threads, smem, st);
        case 5: return launch_kv<T, 5, V>(variant, stride, x, g, taps, dx, partial, geo, xmap, gmap, grid, threads, smem, st);
        case 7: return launch_kv<T, 7, V>(variant, stride, x, g, taps, dx, partial, geo, xmap, gmap, grid, threads, smem, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, g and dx).  x (B,H,W,C), g
// (B,Ho,Wo,C); dx (B,H,W,C) or null, with taps (k*k,C) float32 (read only
// for dx); dk (C,k*k) float32 or null, with partial (gy*tiles_w, k*k, C)
// float32 scratch.  The rest is the plan (kernels/depthwise.py _bwd_plan):
// variant 0 = tile, 1 = gather; vec channels per vector (16 bytes' worth,
// or 1); nv vectors x strips x th threads per block; r outputs per thread
// (must be this file's R); cblocks channel blocks; tiles_w tiles along W,
// nty row tiles per image, walk row tiles per block, stages window
// buffers; the grid (gx, gy) and the dynamic shared bytes.
extern "C" int dw_bwd(const void* x, const void* g, const void* taps, void* dx, void* dk,
                      void* partial, int dtype, int B, int H, int W, int C, int Ho, int Wo,
                      int k, int stride, int dh, int dw, int pad_t, int pad_l,
                      int variant, int vec, int nv, int r, int strips, int th, int cblocks,
                      int tiles_w, int nty, int walk, int stages, int gx, int gy, int smem,
                      void* stream) {
    const int itemsize = dtype == 0 ? 4 : 2;
    const int threads = (variant == 1 ? 2 : 1) * nv * strips * th;  // the gather's two roles
    const int tw = strips * R;
    if ((stride != 1 && stride != 2) || (dtype != 0 && dtype != 1) || variant < 0 || variant > 1)
        return (int)cudaErrorInvalidValue;
    if ((!dx && !dk) || (dx && !taps) || (dk && !partial) || (k != 3 && k != 5 && k != 7))
        return (int)cudaErrorInvalidValue;
    if (r != R || threads < 1 || threads > MAX_THREADS || cblocks < 1 || walk < 1 || stages < 1 || stages > 2
        || (stages == 2 && (variant != 0 || vec == 1)))
        return (int)cudaErrorInvalidValue;
    if (cblocks * nv * vec < C || gx != tiles_w * cblocks || gy != (B * nty + walk - 1) / walk || gy > 65535)
        return (int)cudaErrorInvalidValue;
    // the tiles cover every output and every dx pixel
    if (nty * th < Ho || tiles_w * tw < Wo || stride * nty * th - (stride - 1) * pad_t < H
        || stride * tiles_w * tw - (stride - 1) * pad_l < W)
        return (int)cudaErrorInvalidValue;
    if (variant == 0 ? (dh != 1 || dw != 1) : stride != 1) return (int)cudaErrorInvalidValue;
    if (vec != 1) {
        if (vec * itemsize != 16 || C % vec || (((uintptr_t)x | (uintptr_t)g | (uintptr_t)dx) & 15))
            return (int)cudaErrorInvalidValue;
    }
    if (smem != bwd_smem(variant, k, stride, vec, nv, strips, th, stages, itemsize)) return (int)cudaErrorInvalidValue;

    BGeo geo{B, H, W, C, Ho, Wo, dh, dw, pad_t, pad_l, nv, strips, th, cblocks, tiles_w, nty, walk,
             stages, dx != nullptr, dk != nullptr};
    CUtensorMap xmap{}, gmap{};
    if (variant == 0 && vec != 1) {  // the vector tile loads its windows by TMA
        const int p = (k - 1) / 2;
        int rc = window_map(&xmap, x, dtype, B, H, W, C, nv * vec, (tw - 1) * stride + k, (th - 1) * stride + k);
        if (!rc)
            rc = stride == 1 ? window_map(&gmap, g, dtype, B, Ho, Wo, C, nv * vec, tw + k - 1, th + k - 1)
                             : window_map(&gmap, g, dtype, B, Ho, Wo, C, nv * vec, tw + p, th + p);
        if (rc) return rc;
    }
    cudaStream_t st = (cudaStream_t)stream;
    const float* t = (const float*)taps;
    float* pf = (float*)partial;
    const dim3 grid(gx, gy);
    int rc;
    if (dtype == 0)
        rc = vec == 1 ? launch_v<float, 1>(variant, k, stride, x, g, t, dx, pf, geo, xmap, gmap, grid, threads, smem, st)
                      : launch_v<float, 4>(variant, k, stride, x, g, t, dx, pf, geo, xmap, gmap, grid, threads, smem, st);
    else
        rc = vec == 1 ? launch_v<__nv_bfloat16, 1>(variant, k, stride, x, g, t, dx, pf, geo, xmap, gmap, grid, threads, smem, st)
                      : launch_v<__nv_bfloat16, 8>(variant, k, stride, x, g, t, dx, pf, geo, xmap, gmap, grid, threads, smem, st);
    if (rc) return rc;
    if (dk)
        dw_bwd_dk_final<<<dim3((C + DK_CH - 1) / DK_CH, k * k), dim3(DK_CH, DK_LANES), 0, st>>>(
            pf, (float*)dk, gy * tiles_w, k * k, C);
    return (int)cudaGetLastError();
}
