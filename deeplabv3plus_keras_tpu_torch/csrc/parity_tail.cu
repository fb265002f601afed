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
// Bound: the least traffic is the logits read once, the labels read once
// and, for T2, dlogits written once (at the flagship's 16 x 256^2 x 21
// float32 logits: 0.131 ms for T1 and 0.158 for T2 with one-hot float32
// labels, 0.036 / 0.063 with integer labels, at 3.35 TB/s).  What bounds
// the kernels is the issue rate of the per-class arithmetic of every
// full-resolution pixel: its parity value (4 shared loads, 6 products and
// 3 sums, none fusable), an exp, a product by the softmax's reciprocal, and
// an accurate log (T1, ~20 instructions, in a rolled loop whose latency
// shows) or a reciprocal (T2, its halo pixels done 1.33x), about an SM
// cycle a pixel and class all told: several times the bytes' time.
//
// Design (kernels/parity_tail.py _parity_tail_plan): a block walks `walk`
// tiles of TR x TW half-resolution sites of one image down the rows.  Each
// tile's window of logits (a one-site halo, clamped at the image's edges,
// which is the upsample's edge clamp) and its one-hot label rows are
// copied as they are, by 16-byte asynchronous copies of their aligned
// chunks, into raw rows of shared memory, issued as soon as the previous
// tile's rows are converted, so that they fly during its whole computation.
// The window is then converted, element by element (a multiply-high for
// the division by C), to float32 [row][column][class] with an odd class
// stride CP (CM + 1 in the register instantiations below, else C rounded
// up to odd), so that threads reading one class of neighbouring pixels hit
// distinct banks.  Float32 one-hot labels at an odd C are read from their
// raw rows in place (their stride C is odd; the raw label rows are then
// double-buffered along the walk); others are converted to the stride CP.
// - The class count is a compile-time bound CM (8, 16, 24, 32): a thread
//   makes one pass over C for its pixel with the C parity values in
//   registers (the maximum and the argmax), branch-free over all CM classes
//   (the classes past C padded: logits -inf, labels and weights 0; a branch
//   a class serialised them), one exp a class (ex2 of an FMA) kept in
//   place, one reciprocal of their sum, then one pass for the loss (the
//   probabilities through the pixel's row of shared memory, so that one
//   logf site serves every class: unrolled, the inliner leaves some logf
//   sites as calls, whose saved registers spill) or the slope (in
//   registers).  The class weights are a kernel parameter, read as
//   constant-bank operands.  A label weight y of 0 or 1 (one-hot, integer)
//   takes one log (T1) or reciprocal (T2) a class: of p + eps where y != 0,
//   else of 1 - p + eps; a soft label adds the other term (T1 a branch a
//   class, T2 a branch a pixel, neither taken by one-hot labels).  C > 32
//   takes the CM = 0 instantiation, one tile a block: the parity values
//   recomputed from the window in three passes (T1) or four (T2), the
//   labels and weights read from device memory.  The plan picks the
//   instantiation from C alone; both are held against the plain version.
// - T1: a thread per full-resolution pixel of a tile, summing its pixels'
//   losses across the walk in a fixed order, then a fixed shuffle tree and
//   one value per block in a (B, blocks) buffer; a second kernel sums each
//   sample's row in double in a fixed order: bit-reproducible.  The
//   confusion matrix is counted with integer atomics in shared memory
//   across the block's tiles (when C*C ints fit in 32 KB), then added to the
//   output by integer atomics: exact.
// - T2: phase 1 computes the gradient of every full-resolution pixel that
//   the tile's sites reach (rows 2 i0 - 1 .. 2 (i0 + TR), columns likewise;
//   zero outside the image), a thread a pixel in one round, into shared
//   memory: g = scale_b p (a - dot), a the loss's slope, dot = sum_c a_c p_c.
//   Phase 2: a thread per (site column, class), classes fastest so the
//   stores are coalesced, walks the tile's pixel rows two at a time: each
//   row's column pass over the 4 pixels of its site column is formed once
//   and added, row-weighted, into the two sites it reaches, in a fixed
//   order.  A sample whose scale is 0 (padding) writes zeros.
// - A row window (spatial sharding): only the sites of rows [s0, s1) =
//   [1, H - 1) are computed, the labels hold their 2 (H - 2) rows, and rows
//   0 and H - 1 are context (a row fetched from each neighbouring rank, or
//   the image's edge row clamped); the whole map is s0 = 0, s1 = H.  T1
//   runs on the own rows as a map of H - 2 rows whose window may read one
//   row past each end (the WIN instantiations: the clamp's bounds shift by
//   a compile-time row, so a window costs T1 no register).  T2's tiles
//   cover every row, as it writes every row's dlogits: the pixels of the
//   context rows' sites are zero in its phase 1, so a context row's
//   dlogits are its share of the own sites' gradient, and the clamp's
//   weights at the block's edges meet only those zeros.
//
// C interface: parity_tail_fwd(...) and parity_tail_bwd(...) return
// cudaGetLastError() (or cudaErrorInvalidValue for arguments the kernels do
// not take).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int SUM_THREADS = 256;
// The plan's blocks: T1 a thread a pixel of a 4 x 16-site tile, 3 blocks an
// SM with integer labels (80 registers a thread), 2 with one-hot ones (128;
// their raw label rows make a block's shared memory 91-95 KB at the
// flagship's C); T2 a thread a pixel of its 10 x 34 region, 2 blocks an SM
// (80 registers).  The C <= 32 instantiations spilled at those caps and
// take none.
constexpr int FWD_THREADS = 256, BWD_THREADS = 352, BWD_BLOCKS = 2;
constexpr int MAX_CM = 32;

// The register instantiations' class weights, a kernel parameter.
struct ClassWeights {
    float pw[MAX_CM], nw[MAX_CM];
};

// Element types by code: 0 float32, 1 bfloat16, 2 float16 (logits, one-hot
// labels); 3 int64, 4 int32 (integer labels).  A uniform branch on the code
// inside the loads and stores keeps the instantiations to (CM, one-hot[, WIN]).
__host__ __device__ __forceinline__ int elem_size(int dt) { return dt == 0 ? 4 : 2; }

__device__ __forceinline__ float load_f(const void* p, int dt, size_t i) {
    if (dt == 0) return static_cast<const float*>(p)[i];
    if (dt == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    return __half2float(static_cast<const __half*>(p)[i]);
}

__device__ __forceinline__ void store_f(void* p, int dt, size_t i, float v) {
    if (dt == 0)
        static_cast<float*>(p)[i] = v;
    else if (dt == 1)
        static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
    else
        static_cast<__half*>(p)[i] = __float2half(v);
}

__device__ __forceinline__ int load_id(const void* p, int dt, size_t i) {
    return dt == 3 ? (int)static_cast<const int64_t*>(p)[i] : static_cast<const int32_t*>(p)[i];
}

// 2^x and 1/x by the special-function unit, inputs flushed to zero (the
// arguments here are normal or -inf): 1 ulp-class approximations without
// the guards of __expf and __fdividef.
__device__ __forceinline__ float ex2(float x) {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ float rcp(float x) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

constexpr float LOG2E = 1.4426950408889634f;

// One 16-byte copy from device to shared memory, asynchronous: no register
// holds it while it flies.  wait_async: the thread's copies have landed.
__device__ __forceinline__ void copy_async(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void commit_async() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void wait_async() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }


__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// n / d by a multiply-high, exact for n * d < 2^32; m = ceil(2^32 / d),
// computed on the host (a 64-bit division on the card is a subroutine
// call, whose saved registers ptxas counts as spills).
struct FastDiv {
    unsigned long long m;
    __device__ explicit FastDiv(unsigned long long m_) : m(m_) {}
    __device__ __forceinline__ int operator()(int n) const { return (int)(((unsigned long long)n * m) >> 32); }
};

unsigned long long div_magic(int d) { return ((1ull << 32) + d - 1) / d; }

// A run of n elements (code dt) of a tensor, copied into shared memory as
// float32, element e to dst[(e / C) * cp + e % C], in two steps: its aligned
// 16-byte chunks copied as they are, asynchronously, into a raw row of
// shared memory (the first and last chunk reaching past the run: a 16-byte
// aligned chunk holding one byte of the tensor lies in a mapped page), then
// each element of the run converted to its place.  The lanes of one warp
// take the chunks, then the elements; none where src is null.
struct Run {
    const uint4* src;  // the first aligned chunk
    float* dst;
    int dt, n, mis, chunks;

    __device__ Run() : src(nullptr), dst(nullptr), dt(0), n(0), mis(0), chunks(0) {}
    __device__ Run(float* d, const void* base, int dt_, size_t off, int n_) : dst(d), dt(dt_), n(n_) {
        const int es = elem_size(dt);
        const char* p = static_cast<const char*>(base) + off * es;
        mis = (int)(((uintptr_t)p & 15) / es);
        src = reinterpret_cast<const uint4*>(p - mis * es);
        chunks = (n + mis + 16 / es - 1) / (16 / es);
    }

    __device__ __forceinline__ void issue(uint4* raw, int lane) const {
        for (int ch = lane; ch < chunks; ch += 32) copy_async(raw + ch, src + ch);
    }

    // After the copies landed, element by element (consecutive lanes on
    // consecutive elements: no bank conflict on either side).
    template <typename T>
    __device__ __forceinline__ void convert_as(const uint4* raw, int lane, int C, int cp,
                                               const FastDiv& div_c) const {
        const T* r = reinterpret_cast<const T*>(raw) + mis;
        for (int e = lane; e < n; e += 32) {
            const int p = div_c(e);
            dst[(size_t)p * cp + e - p * C] = to_float(r[e]);
        }
    }

    __device__ __forceinline__ void convert(const uint4* raw, int lane, int C, int cp, const FastDiv& div_c) const {
        if (dt == 0)
            convert_as<float>(raw, lane, C, cp, div_c);
        else if (dt == 1)
            convert_as<__nv_bfloat16>(raw, lane, C, cp, div_c);
        else
            convert_as<__half>(raw, lane, C, cp, div_c);
    }
};

// 16-byte chunks a raw row of n elements may span (4-byte elements, any
// alignment).
__host__ __device__ __forceinline__ int raw_chunks(int n) { return (n * 4 + 15) / 16 + 1; }

// Window row k (rows i0 - 1 .. i0 + TR, columns j0 - 1 .. j0 + TW of image
// xb, each index clamped to the image, whose rows -ctx .. H - 1 + ctx are
// readable: ctx 1 for T1's row window): the run of its columns inside the
// image.
__device__ __forceinline__ Run window_run(float* win, const void* xb, int xdt, int H, int W, int C, int cp, int i0,
                                          int j0, int xc, int k, int ctx) {
    const int lo = max(j0 - 1, 0), hi = min(j0 + xc - 2, W - 1);
    const int row = min(max(i0 - 1 + k, -ctx), H - 1 + ctx);
    return Run(win + ((size_t)k * xc + lo - (j0 - 1)) * cp, xb, xdt, ((size_t)row * W + lo) * C, (hi - lo + 1) * C);
}

// Window row k's clamped columns outside that run (edge tiles), element by
// element by the lanes of one warp.
__device__ __forceinline__ void window_edges(float* win, const void* xb, int xdt, int H, int W, int C, int cp,
                                             const FastDiv& div_c, int i0, int j0, int xc, int k, int lane,
                                             int ctx) {
    const int lo = max(j0 - 1, 0), hi = min(j0 + xc - 2, W - 1);
    const int run = hi - lo + 1, first = lo - (j0 - 1), edge = (xc - run) * C;
    const int row = min(max(i0 - 1 + k, -ctx), H - 1 + ctx);
    for (int e = lane; e < edge; e += 32) {
        const int q = div_c(e), c = e - q * C;
        const int jj = q < first ? q : q + run;
        const int col = min(max(j0 - 1 + jj, 0), W - 1);
        win[((size_t)k * xc + jj) * cp + c] = load_f(xb, xdt, ((size_t)row * W + col) * C + c);
    }
}

// The one-hot labels of full-resolution row r0 + k, columns s0 .. s0 + nc - 1
// of image b (those inside the image), to dst[(k * nc + s - s0) * cp + c]; no
// run outside the image.
__device__ __forceinline__ Run label_run(float* dst, const void* label, int ldt, int b, int H2, int W2, int C, int cp,
                                         int r0, int s0, int nc, int k) {
    const int r = r0 + k, lo = max(s0, 0), hi = min(s0 + nc, W2);
    if (r < 0 || r >= H2 || hi <= lo) return Run();
    return Run(dst + (size_t)(k * nc + lo - s0) * cp, label, ldt, (((size_t)b * H2 + r) * W2 + lo) * C,
               (hi - lo) * C);
}

// A tile's staging in two steps, pipelined by the caller: issue copies its
// window rows and one-hot label rows as they are into raw rows of shared
// memory, asynchronously (a warp a row), and loads the integer label of the
// thread's pixel; commit, once the caller is done with the previous tile,
// waits for the copies, syncs, and converts them into the window and label
// layouts, with the window's clamped columns.  Issued right after the
// previous tile's commit, the copies fly during its whole computation.
// CTX: the rows of x readable past each end of the map (T1's row window);
// lwin: the labels hold the rows of sites 1 .. H - 2 alone (T2's).
template <int CTX>
struct Stager {
    float *win, *lab;
    uint4 *raw_w, *raw_l;  // raw rows, row_w and row_l chunks apart
    const void *xb, *label;
    int xdt, ldt, b, H, W, C, cp, xc, xr, lr0, lc0, lrows, lcols, row_w, row_l;  // lr0, lc0: label rows' origin - 2 i0, 2 j0
    bool dense;   // stage one-hot labels
    bool direct;  // and read them from the raw rows: float32 at an odd C (no bank conflicts), no conversion
    int lwin;
    int tl;

    __device__ __forceinline__ Run labels(int i0, int j0, int k) const {
        return label_run(lab, label, ldt, b, 2 * (H - 2 * lwin), 2 * W, C, cp, 2 * (i0 - lwin) + lr0, 2 * j0 + lc0,
                         lcols, k);
    }

    // The raw label rows of tile w of the walk: read in place (direct), the
    // next tile's copies land in the other half.
    __device__ __forceinline__ uint4* raw_labels(int w) const {
        return raw_l + (direct && (w & 1) ? (size_t)lrows * row_l : 0);
    }

    // Tile w of the walk, at (i0, j0); the thread's integer label is pixel
    // (pr, ps) of its label grid, where inside the image.
    __device__ __forceinline__ void issue(int w, int i0, int j0, int pr, int ps, bool has_pixel) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
        for (int k = warp; k < xr; k += nw)
            window_run(win, xb, xdt, H, W, C, cp, i0, j0, xc, k, CTX).issue(raw_w + (size_t)k * row_w, lane);
        if (dense)
            for (int k = warp; k < lrows; k += nw) labels(i0, j0, k).issue(raw_labels(w) + (size_t)k * row_l, lane);
        commit_async();
        const int r = 2 * (i0 - lwin) + lr0 + pr, s = 2 * j0 + lc0 + ps, H2 = 2 * (H - 2 * lwin);
        tl = ldt >= 3 && has_pixel && r >= 0 && r < H2 && s >= 0 && s < 2 * W
                 ? load_id(label, ldt, ((size_t)b * H2 + r) * 2 * W + s)
                 : 0;
    }

    // The tile at (i0, j0) into the window and label layouts.  Syncs first:
    // every thread's copies have landed, and every thread is done with the
    // previous tile; the caller syncs after.
    __device__ __forceinline__ void commit(int w, int i0, int j0, const FastDiv& div_c) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
        wait_async();
        __syncthreads();
        for (int k = warp; k < xr; k += nw) {
            window_run(win, xb, xdt, H, W, C, cp, i0, j0, xc, k, CTX)
                .convert(raw_w + (size_t)k * row_w, lane, C, cp, div_c);
            window_edges(win, xb, xdt, H, W, C, cp, div_c, i0, j0, xc, k, lane, CTX);
        }
        if (dense && !direct)
            for (int k = warp; k < lrows; k += nw)
                labels(i0, j0, k).convert(raw_labels(w) + (size_t)k * row_l, lane, C, cp, div_c);
    }

    // The one-hot labels of pixel (pr, ps) of the tile's label grid: its raw
    // row (direct), else its staged row of the label layout (at `row`).
    __device__ __forceinline__ const float* pixel_labels(int w, int i0, int j0, int pr, int ps, const float* row) const {
        if (!direct) return row;
        const Run r = labels(i0, j0, pr);
        const int s0 = 2 * j0 + lc0;
        return reinterpret_cast<const float*>(raw_labels(w) + (size_t)pr * row_l) + r.mis
               + (size_t)(ps - (max(s0, 0) - s0)) * C;
    }
};

// Fill classes C .. CM - 1 of n pixel rows (stride cp) with v: the padding
// the register instantiations read unconditionally.
__device__ __forceinline__ void fill_pad(float* rows, int n, int cp, int C, int CM, float v) {
    for (int p = threadIdx.x; p < n; p += blockDim.x)
        for (int c = C; c < CM; ++c) rows[(size_t)p * cp + c] = v;
}

// One full-resolution pixel's four window entries and lerp weights.
struct Pixel {
    const float* aa;  // (tap row a, tap column a); (a, b) is aa + cp
    int cp, row;      // row: the window's row stride, xc * cp
    float wra, wrb, wca, wcb;

    // The pixel (r, s) of a window whose entry (0, 0) is site (i0 - 1, j0 - 1).
    __device__ __forceinline__ Pixel(const float* win, int xc, int cp_, int r, int s, int i0, int j0)
        : cp(cp_), row(xc * cp_) {
        const int kr = (r >> 1) - i0 + 1, kc = (s >> 1) - j0 + 1;
        const int ra = (r & 1) ? kr : kr - 1, ca = (s & 1) ? kc : kc - 1;
        wra = (r & 1) ? 0.75f : 0.25f;
        wrb = (r & 1) ? 0.25f : 0.75f;
        wca = (s & 1) ? 0.75f : 0.25f;
        wcb = (s & 1) ? 0.25f : 0.75f;
        aa = win + (size_t)ra * row + (size_t)ca * cp;
    }

    __device__ __forceinline__ static float blend(float a, float b, float wa, float wb) {
        return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
    }

    // The row blend of each tap column, then the column blend.
    __device__ __forceinline__ float value(int c) const {
        const float* p = aa + c;
        return blend(blend(p[0], p[row], wra, wrb), blend(p[cp], p[row + cp], wra, wrb), wca, wcb);
    }
};

// ---------------------------------------------------------------------------
// per-pixel work

// T1 with C <= CM, first half: the pixel's probabilities into its row ps of
// shared memory (all CM classes, branch-free: a class past C is padded
// with -inf, so its exp is 0 and the maximum does not move), the values and
// their exps in registers; returns the argmax (the first maximum).
template <int CM>
__device__ __forceinline__ int pixel_probs(const Pixel& px, float* ps) {
    float v[CM];
    float m = 0.f;
    int pred = 0;
#pragma unroll
    for (int c = 0; c < CM; ++c) {
        v[c] = px.value(c);
        if (c == 0 || v[c] > m) {
            m = v[c];
            pred = c;
        }
    }
    const float mb = -m * LOG2E;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < CM; ++c) {
        v[c] = ex2(fmaf(v[c], LOG2E, mb));
        sum += v[c];
    }
    const float inv = 1.f / sum;
#pragma unroll
    for (int c = 0; c < CM; ++c) ps[c] = v[c] * inv;
    return pred;
}

// T1 with C <= CM, second half: the pixel's loss from its probabilities ps,
// rolled over C so that logf has one site.  ys: its staged one-hot labels
// (DENSE), else tl is its class; truth: the label's class (the first
// maximum of a one-hot row).  A soft label (not 0 or 1) adds the other
// term (a branch a class, rarely taken).
template <bool DENSE>
__device__ __forceinline__ float pixel_loss(const float* ps, const float* ys, int tl, const ClassWeights& wp, int C,
                                            float eps, int& truth) {
    float acc = 0.f, ymax = 0.f;
    truth = tl;
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
        const float p = ps[c];
        const float y = DENSE ? ys[c] : (c == tl ? 1.f : 0.f);
        if (DENSE && (c == 0 || y > ymax)) {
            ymax = y;
            truth = c;
        }
        const bool pos = y != 0.f;
        acc += (pos ? wp.pw[c] * y : wp.nw[c] * (1.f - y)) * logf(pos ? p + eps : 1.f - p + eps);
        if (DENSE && pos && y != 1.f) acc += wp.nw[c] * (1.f - y) * logf(1.f - p + eps);
    }
    return -acc;
}

// T1 with any C: three passes, the values recomputed from the window;
// rolled, so that each of expf and logf has one site.
template <bool DENSE>
__device__ __forceinline__ float pixel_fwd_wide(const Pixel& px, const void* label, int ldt, size_t pix, int tl,
                                                const float* pw, const float* nw, int C, float eps, int& truth,
                                                int& pred) {
    float m = px.value(0);
    pred = 0;
    for (int c = 1; c < C; ++c) {
        const float v = px.value(c);
        if (v > m) {
            m = v;
            pred = c;
        }
    }
    float sum = 0.f;
#pragma unroll 1
    for (int c = 0; c < C; ++c) sum += expf(px.value(c) - m);
    float loss = 0.f, ymax = 0.f;
    truth = tl;
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
        const float p = expf(px.value(c) - m) / sum;
        const float y = DENSE ? load_f(label, ldt, pix * C + c) : (c == tl ? 1.f : 0.f);
        if (DENSE && (c == 0 || y > ymax)) {
            ymax = y;
            truth = c;
        }
        if (y != 0.f) loss += pw[c] * y * logf(p + eps);
        if (y != 1.f) loss += nw[c] * (1.f - y) * logf(1.f - p + eps);
    }
    return -loss;
}

// T2 with C <= CM: the pixel's gradient into gq, the values and
// probabilities in registers and the slopes in gq, over all CM classes
// unconditionally (padded as for T1, weights 0).  ys: its one-hot labels
// (DENSE; read at c < C only, as ys may be gq itself), else tl is its
// class.  A pixel with a soft label (not 0 or 1) takes both terms of the
// slope (a branch a pixel, rarely taken).
template <int CM, bool DENSE>
__device__ __forceinline__ void pixel_bwd_reg(const Pixel& px, float* gq, const float* ys, int tl,
                                              const ClassWeights& wp, int C, float sc, float eps) {
    float v[CM];
    float m = 0.f;
#pragma unroll
    for (int c = 0; c < CM; ++c) {
        v[c] = px.value(c);
        m = c == 0 ? v[c] : fmaxf(m, v[c]);
    }
    const float mb = -m * LOG2E;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < CM; ++c) {
        v[c] = ex2(fmaf(v[c], LOG2E, mb));
        sum += v[c];
    }
    const float inv = 1.f / sum;
    bool soft = false;
    if constexpr (DENSE) {
#pragma unroll
        for (int c = 0; c < CM; ++c) {
            const float y = c < C ? ys[c] : 0.f;
            soft |= y != 0.f && y != 1.f;
        }
    }
    float dot = 0.f;
    if (DENSE && soft) {
#pragma unroll
        for (int c = 0; c < CM; ++c) {
            const float p = v[c] * inv, y = c < C ? ys[c] : 0.f;
            float s = 0.f;
            if (y != 0.f) s -= wp.pw[c] * y * rcp(p + eps);
            if (y != 1.f) s += wp.nw[c] * (1.f - y) * rcp(1.f - p + eps);
            gq[c] = s;
            dot += s * p;
        }
    } else {
#pragma unroll
        for (int c = 0; c < CM; ++c) {
            const float p = v[c] * inv;
            const float y = DENSE ? (c < C ? ys[c] : 0.f) : (c == tl ? 1.f : 0.f);
            const bool pos = y != 0.f;
            const float s = (pos ? -wp.pw[c] * y : wp.nw[c] * (1.f - y)) * rcp(pos ? p + eps : 1.f - p + eps);
            gq[c] = s;
            dot += s * p;
        }
    }
#pragma unroll
    for (int c = 0; c < CM; ++c) gq[c] = sc * (v[c] * inv * (gq[c] - dot));
}

// dl/dp_c of the class-balanced loss, a term whose label weight is 0 left out.
__device__ __forceinline__ float loss_slope(float p, float y, float pw, float nw, float eps) {
    float a = 0.f;
    if (y != 0.f) a -= pw * y / (p + eps);
    if (y != 1.f) a += nw * (1.f - y) / (1.f - p + eps);
    return a;
}

// T2 with any C: four passes, the values recomputed from the window.
template <bool DENSE>
__device__ __forceinline__ void pixel_bwd_wide(const Pixel& px, float* gq, const void* label, int ldt, size_t pix,
                                               int tl, const float* pw, const float* nw, int C, float sc, float eps) {
    float m = px.value(0);
    for (int c = 1; c < C; ++c) m = fmaxf(m, px.value(c));
    float sum = 0.f;
    for (int c = 0; c < C; ++c) sum += expf(px.value(c) - m);
    float dot = 0.f;
    for (int c = 0; c < C; ++c) {
        const float p = expf(px.value(c) - m) / sum;
        const float y = DENSE ? load_f(label, ldt, pix * C + c) : (c == tl ? 1.f : 0.f);
        dot += loss_slope(p, y, pw[c], nw[c], eps) * p;
        gq[c] = p;
    }
    for (int c = 0; c < C; ++c) {
        const float p = gq[c];
        const float y = DENSE ? load_f(label, ldt, pix * C + c) : (c == tl ? 1.f : 0.f);
        gq[c] = sc * (p * (loss_slope(p, y, pw[c], nw[c], eps) - dot));
    }
}

// ---------------------------------------------------------------------------
// the kernels

// Shared memory of T1: the raw window rows, the raw label rows (CM > 0,
// DENSE), the warps' sums [32], the block's matrix [C*C] (hist), the
// window, the pixels' probabilities (CM > 0), the staged labels (CM > 0,
// DENSE, not read from the raw rows).  WIN: x's images hold H + 2 rows,
// the H computed ones after a context row (x points at row 1 of image 0).
template <int CM, bool DENSE, bool WIN>
__global__ void __launch_bounds__(FWD_THREADS, CM > 0 && DENSE ? (CM == 32 ? 1 : 2) : 3)
    tail_fwd_kernel(const void* __restrict__ x, int xdt, const void* __restrict__ label, int ldt,
                    const float* __restrict__ wts, const __grid_constant__ ClassWeights wp,
                    const int* __restrict__ valid, float* __restrict__ partial, int* __restrict__ cm, int H, int W,
                    int C, unsigned long long mc, int cp, int TR, int TW, int walk, int hist_in_smem, float eps) {
    extern __shared__ uint4 smem4[];
    constexpr bool STAGED = CM > 0 && DENSE;
    const int xr = TR + 2, xc = TW + 2, t = threadIdx.x, npx = 4 * TR * TW;
    const int row_w = raw_chunks(xc * C), row_l = raw_chunks(2 * TW * C);
    const bool direct = STAGED && (C & 1) && ldt == 0;
    uint4* raw_l = smem4 + (size_t)xr * row_w;
    float* red = reinterpret_cast<float*>(raw_l + (STAGED ? (size_t)(direct ? 2 : 1) * 2 * TR * row_l : 0));
    int* hist = reinterpret_cast<int*>(red + 32);
    float* win = reinterpret_cast<float*>(hist + (hist_in_smem ? C * C : 0));
    float* prob = win + (size_t)xr * xc * cp;
    float* lab = prob + (CM > 0 ? (size_t)npx * cp : 0);
    const int b = blockIdx.z, j0 = blockIdx.x * TW;
    const FastDiv div_c(mc);
    const void* xb = static_cast<const char*>(x) + (size_t)b * (H + 2 * WIN) * W * C * elem_size(xdt);
    // the thread's pixel: (pr, ps) of the tile's 2 TR x 2 TW
    const int pr = t / (2 * TW), ps = t % (2 * TW);
    const bool has_pixel = t < npx;
    Stager<WIN> st{win, lab,   smem4, raw_l, xb,    label, xdt,    ldt,    b, H, W, C, cp, xc, xr, 0, 0,
                   2 * TR, 2 * TW, row_w, row_l, STAGED, direct, 0};

    if constexpr (CM > 0) fill_pad(win, xr * xc, cp, C, CM, -__int_as_float(0x7f800000));
    if (hist_in_smem)
        for (int e = t; e < C * C; e += blockDim.x) hist[e] = 0;
    const bool counted = valid == nullptr || valid[b] != 0;
    float loss = 0.f;
    int i0 = blockIdx.y * walk * TR;
    st.issue(0, i0, j0, pr, ps, has_pixel);
    for (int w = 0; w < walk && i0 < H; ++w, i0 += TR) {
        const int tl = st.tl;
        st.commit(w, i0, j0, div_c);
        __syncthreads();
        const float* ys = st.pixel_labels(w, i0, j0, pr, ps, lab + (size_t)t * cp);
        if (w + 1 < walk && i0 + TR < H) st.issue(w + 1, i0 + TR, j0, pr, ps, has_pixel);  // flies during this tile
        const int r = 2 * i0 + pr, s = 2 * j0 + ps;
        const bool inside = has_pixel && r < 2 * H && s < 2 * W;
        int truth = -1, pred = 0;
        if constexpr (CM > 0) {
            const Pixel px(win, xc, cp, r, s, i0, j0);
            float* p = prob + (size_t)t * cp;
            if (inside) pred = pixel_probs<CM>(px, p);
            if (inside) loss += pixel_loss<DENSE>(p, ys, tl, wp, C, eps, truth);
        } else {
            if (inside)
                loss += pixel_fwd_wide<DENSE>(Pixel(win, xc, cp, r, s, i0, j0), label, ldt,
                                              ((size_t)b * 2 * H + r) * 2 * W + s, tl, wts, wts + C, C, eps, truth,
                                              pred);
        }
        if (inside && counted && truth >= 0 && truth < C)
            atomicAdd((hist_in_smem ? hist : cm) + truth * C + pred, 1);
    }
#pragma unroll
    for (int h = 16; h > 0; h >>= 1) loss += __shfl_down_sync(0xffffffffu, loss, h);
    if ((t & 31) == 0) red[t >> 5] = loss;
    __syncthreads();
    if (t == 0) {
        float s = 0.f;
        for (int k = 0; k < (int)(blockDim.x >> 5); ++k) s += red[k];
        partial[((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
    }
    if (hist_in_smem)
        for (int e = t; e < C * C; e += blockDim.x)
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
__device__ __forceinline__ float4 site_weights(int i, int n) {
    return make_float4(i >= 1 ? 0.25f : 0.f, i == 0 ? 1.f : 0.75f, i == n - 1 ? 1.f : 0.75f,
                       i + 1 <= n - 1 ? 0.25f : 0.f);
}

// The column pass of one pixel row: its 4 pixels of a site column, weighted.
__device__ __forceinline__ float col_pass(const float* r, int cp, const float4& w) {
    float h = 0.f;
    h += w.x * r[0];
    h += w.y * r[cp];
    h += w.z * r[2 * cp];
    h += w.w * r[3 * cp];
    return h;
}

// Shared memory of T2: the raw window rows, the raw label rows (CM > 0,
// DENSE), the window, the gradient of the tile's pixels and their halo ring
// (first their staged labels: CM > 0, DENSE, not read from the raw rows).
template <int CM, bool DENSE>
__global__ void __launch_bounds__(BWD_THREADS, CM == 32 ? 1 : BWD_BLOCKS)
    tail_bwd_kernel(const void* __restrict__ x, int xdt, const void* __restrict__ label, int ldt,
                    const float* __restrict__ wts, const __grid_constant__ ClassWeights wp,
                    const float* __restrict__ scale, void* __restrict__ dx, int H, int W, int C, int lw,
                    unsigned long long mc, int cp, int TR, int TW, int walk, float eps) {
    extern __shared__ uint4 smem4[];
    constexpr bool STAGED = CM > 0 && DENSE;
    const int xr = TR + 2, xc = TW + 2, rr = 2 * TR + 2, rc = 2 * TW + 2;
    const int nt = blockDim.x, t = threadIdx.x;
    const int row_w = raw_chunks(xc * C), row_l = raw_chunks(rc * C);
    const bool direct = STAGED && (C & 1) && ldt == 0;
    uint4* raw_l = smem4 + (size_t)xr * row_w;
    float* win = reinterpret_cast<float*>(raw_l + (STAGED ? (size_t)(direct ? 2 : 1) * rr * row_l : 0));
    float* g = win + (size_t)xr * xc * cp;
    const int b = blockIdx.z, j0 = blockIdx.x * TW, first = blockIdx.y * walk * TR;
    const float sc = scale[b];
    const size_t img = (size_t)b * H * W * C;

    if (sc == 0.f) {  // a padded sample: no gradient
        const int rows = min(walk * TR, H - first);
        for (int e = t; e < rows * TW * C; e += nt) {
            const int li = e / (TW * C), rem = e - li * TW * C, lj = rem / C, c = rem - lj * C;
            const int i = first + li, j = j0 + lj;
            if (j < W) store_f(dx, xdt, img + ((size_t)i * W + j) * C + c, 0.f);
        }
        return;
    }
    const FastDiv div_c(mc);
    // the thread's pixel: (pr, ps) of the region's rr x rc, from (2 i0 - 1, 2 j0 - 1)
    const int pr = t / rc, ps = t % rc;
    const bool has_pixel = t < rr * rc;
    Stager<0> st{win, g,  smem4, raw_l, static_cast<const char*>(x) + img * elem_size(xdt),
                 label, xdt, ldt, b, H, W, C, cp, xc, xr, -1, -1, rr, rc, row_w, row_l, STAGED, direct, lw};
    if constexpr (CM > 0) {
        fill_pad(win, xr * xc, cp, C, CM, -__int_as_float(0x7f800000));
    }
    int i0 = first;
    st.issue(0, i0, j0, pr, ps, has_pixel);
    for (int w = 0; w < walk && i0 < H; ++w, i0 += TR) {
        const int tl = st.tl;
        st.commit(w, i0, j0, div_c);
        __syncthreads();
        const float* ys = st.pixel_labels(w, i0, j0, pr, ps, g + (size_t)t * cp);
        if (w + 1 < walk && i0 + TR < H) st.issue(w + 1, i0 + TR, j0, pr, ps, has_pixel);  // flies during this tile

        // phase 1: the gradient of each full-resolution pixel the tile reaches
        if (has_pixel) {
            const int r = 2 * i0 - 1 + pr, s = 2 * j0 - 1 + ps;
            float* gq = g + (size_t)t * cp;
            if (r < 2 * lw || r >= 2 * (H - lw) || s < 0 || s >= 2 * W) {
                for (int c = 0; c < C; ++c) gq[c] = 0.f;
            } else {
                const Pixel px(win, xc, cp, r, s, i0, j0);
                if constexpr (CM > 0)
                    pixel_bwd_reg<CM, DENSE>(px, gq, ys, tl, wp, C, sc, eps);
                else
                    pixel_bwd_wide<DENSE>(px, gq, label, ldt, ((size_t)b * 2 * (H - 2 * lw) + r - 2 * lw) * 2 * W + s,
                                          tl, wts, wts + C, C, sc, eps);
            }
        }
        __syncthreads();

        // phase 2: down the tile's pixel rows two at a time (rows 2 li, 2 li + 1:
        // rows 0 and 1 of site li, rows 2 and 3 of site li - 1, which they
        // complete), each row's column pass over the 4 pixels of site column lj
        const int cols = min(TW, W - j0);
        for (int e = t; e < TW * C; e += nt) {
            const int lj = div_c(e), c = e - lj * C;
            if (lj >= cols) continue;
            const int j = j0 + lj;
            const float4 wc = site_weights(j, W);
            const float* col = g + (size_t)(2 * lj) * cp + c;
            float lo = 0.f;
            for (int li = 0; li <= TR; ++li) {
                const float* r0 = col + (size_t)(2 * li) * rc * cp;
                const float h0 = col_pass(r0, cp, wc), h1 = col_pass(r0 + (size_t)rc * cp, cp, wc);
                if (li >= 1) {
                    const float4 wr = site_weights(i0 + li - 1, H);
                    lo += wr.z * h0;
                    lo += wr.w * h1;
                    if (i0 + li - 1 < H) store_f(dx, xdt, img + ((size_t)(i0 + li - 1) * W + j) * C + c, lo);
                }
                const float4 wr = site_weights(i0 + li, H);
                lo = 0.f;
                lo += wr.x * h0;
                lo += wr.y * h1;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// launch

long long fwd_smem_need(int C, int cp, int TR, int TW, int cmax, int dense, int direct, int hist) {
    long long s = 16LL * (TR + 2) * raw_chunks((TW + 2) * C) + 4 * 32 + (hist ? 4LL * C * C : 0)
                  + 4LL * cp * (TR + 2) * (TW + 2);
    if (cmax > 0) s += 4LL * cp * 4 * TR * TW * (dense && !direct ? 2 : 1);
    if (cmax > 0 && dense) s += 16LL * (direct ? 2 : 1) * 2 * TR * raw_chunks(2 * TW * C);
    return s;
}

long long bwd_smem_need(int C, int cp, int TR, int TW, int cmax, int dense, int direct) {
    long long s = 16LL * (TR + 2) * raw_chunks((TW + 2) * C)
                  + 4LL * cp * ((long long)(TR + 2) * (TW + 2) + (long long)(2 * TR + 2) * (2 * TW + 2));
    if (cmax > 0 && dense) s += 16LL * (direct ? 2 : 1) * (2 * TR + 2) * raw_chunks((2 * TW + 2) * C);
    return s;
}

// [s0, s1): the whole map (0, H) or the row window (1, H - 1).
bool plan_ok(int B, int H, int W, int C, int s0, int s1, int cp, int TR, int TW, int cmax, int walk, int threads,
             int pixels, int max_threads) {
    return B >= 1 && H >= 1 && W >= 1 && C >= 1 && ((s0 == 0 && s1 == H) || (s0 == 1 && s1 == H - 1 && H >= 3))
           && cp >= C && cp >= cmax && TR >= 1 && TW >= 1 && walk >= 1
           && threads >= pixels && threads % 32 == 0 && threads <= max_threads && B <= 65535
           && (H + TR * walk - 1) / (TR * walk) <= 65535
           && (cmax == 0 || cmax == 8 || cmax == 16 || cmax == 24 || cmax == 32) && (cmax == 0 || C <= cmax)
           && (long long)(2 * TW + 2) * C * C < (1LL << 32);
}

template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

ClassWeights class_weights(const float* host_wts, int C) {
    ClassWeights w;
    memset(&w, 0, sizeof(w));
    if (host_wts && C <= MAX_CM) {
        memcpy(w.pw, host_wts, C * sizeof(float));
        memcpy(w.nw, host_wts + C, C * sizeof(float));
    }
    return w;
}

// T1 on the site rows [s0, s1) of x's H: the whole map (0, H), or the row
// window (1, H - 1), which runs the WIN instantiation on rows 1 .. H - 2.
template <int CM, bool DENSE, bool WIN>
int launch_fwd(const void* x, int xdt, const void* label, int ldt, const void* wts, const float* host_wts,
               const void* valid, void* partial, void* sums, void* cm, int B, int H, int W, int C, int cp, int TR,
               int TW, int walk, int threads, int smem, int hist, float eps, cudaStream_t st) {
    cudaError_t e = allow_smem(tail_fwd_kernel<CM, DENSE, WIN>, smem);
    if (e != cudaSuccess) return (int)e;
    const int rows = H - 2 * WIN;
    const void* own = static_cast<const char*>(x) + (WIN ? (size_t)W * C * elem_size(xdt) : 0);
    const dim3 grid((W + TW - 1) / TW, (rows + TR * walk - 1) / (TR * walk), B);
    tail_fwd_kernel<CM, DENSE, WIN><<<grid, threads, smem, st>>>(own, xdt, label, ldt, (const float*)wts,
                                                                 class_weights(host_wts, C), (const int*)valid,
                                                                 (float*)partial, (int*)cm, rows, W, C,
                                                                 div_magic(C), cp, TR, TW, walk, hist, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    tail_sum_kernel<<<B, SUM_THREADS, 0, st>>>((const float*)partial, (int)(grid.x * grid.y), (float*)sums);
    return (int)cudaGetLastError();
}

template <int CM, bool DENSE>
int launch_bwd(const void* x, int xdt, const void* label, int ldt, const void* wts, const float* host_wts,
               const void* scale, void* dx, int B, int H, int W, int C, int lw, int cp, int TR, int TW, int walk,
               int threads, int smem, float eps, cudaStream_t st) {
    cudaError_t e = allow_smem(tail_bwd_kernel<CM, DENSE>, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((W + TW - 1) / TW, (H + TR * walk - 1) / (TR * walk), B);
    tail_bwd_kernel<CM, DENSE><<<grid, threads, smem, st>>>(x, xdt, label, ldt, (const float*)wts,
                                                            class_weights(host_wts, C), (const float*)scale, dx, H,
                                                            W, C, lw, div_magic(C), cp, TR, TW, walk, eps);
    return (int)cudaGetLastError();
}

// The (class bound, one-hot) instantiation of cmax and the label code.
template <template <int, bool> class F, typename... A>
int dispatch(int cmax, bool dense, A... args) {
#define PT_CLASSES(D)                                   \
    switch (cmax) {                                     \
        case 0: return F<0, D>::run(args...);           \
        case 8: return F<8, D>::run(args...);           \
        case 16: return F<16, D>::run(args...);         \
        case 24: return F<24, D>::run(args...);         \
        case 32: return F<32, D>::run(args...);         \
        default: return (int)cudaErrorInvalidValue;     \
    }
    if (dense) {
        PT_CLASSES(true)
    }
    PT_CLASSES(false)
#undef PT_CLASSES
}

template <int CM, bool D> struct Fwd {
    template <typename... A> static int run(bool win, A... args) {
        return win ? launch_fwd<CM, D, true>(args...) : launch_fwd<CM, D, false>(args...);
    }
};
template <int CM, bool D> struct Bwd {
    template <typename... A> static int run(A... args) { return launch_bwd<CM, D>(args...); }
};

}  // namespace

// wts: [pw; nw] (2, C) float32 on the card; host_wts: the same on the host
// (read at the launch, for the register instantiations' parameter); [s0, s1):
// the site rows computed, (0, H) for the whole map, (1, H - 1) for a row
// window.
extern "C" int parity_tail_fwd(const void* x, int xdt, const void* label, int ldt, const void* wts,
                               const float* host_wts, const void* valid, void* partial, void* sums, void* cm, int B,
                               int H, int W, int C, int s0, int s1, int cp, int TR, int TW, int walk, int cmax,
                               int threads, int smem, int hist, float eps, void* stream) {
    const bool dense = ldt >= 0 && ldt <= 2, direct = dense && (C & 1) && ldt == 0;
    if (!plan_ok(B, H, W, C, s0, s1, cp, TR, TW, cmax, walk, threads, 4 * TR * TW, FWD_THREADS) || xdt < 0
        || xdt > 2 || ldt < 0 || ldt > 4 || (cmax > 0 && (!hist || !host_wts))
        || smem < fwd_smem_need(C, cp, TR, TW, cmax, dense, direct, hist)
        || smem > 227 * 1024 || !x || !label || !wts || !partial || !sums || !cm)
        return (int)cudaErrorInvalidValue;
    return dispatch<Fwd>(cmax, dense, s0 > 0, x, xdt, label, ldt, wts, host_wts, valid, partial, sums, cm, B, H, W, C,
                         cp, TR, TW, walk, threads, smem, hist, eps, (cudaStream_t)stream);
}

extern "C" int parity_tail_bwd(const void* x, int xdt, const void* label, int ldt, const void* wts,
                               const float* host_wts, const void* scale, void* dx, int B, int H, int W, int C, int s0,
                               int s1, int cp, int TR, int TW, int walk, int cmax, int threads, int smem, float eps,
                               void* stream) {
    if (!plan_ok(B, H, W, C, s0, s1, cp, TR, TW, cmax, walk, threads, (2 * TR + 2) * (2 * TW + 2), BWD_THREADS)
        || xdt < 0 || xdt > 2 || ldt < 0 || ldt > 4 || (cmax > 0 && !host_wts)
        || smem < bwd_smem_need(C, cp, TR, TW, cmax, ldt <= 2, ldt == 0 && (C & 1))
        || smem > 227 * 1024 || !x || !label || !wts || !scale || !dx)
        return (int)cudaErrorInvalidValue;
    return dispatch<Bwd>(cmax, ldt <= 2, x, xdt, label, ldt, wts, host_wts, scale, dx, B, H, W, C, s0, cp, TR, TW,
                         walk, threads, smem, eps, (cudaStream_t)stream);
}
