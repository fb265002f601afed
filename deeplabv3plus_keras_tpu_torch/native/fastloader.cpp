// fastloader: native batch image decode + canvas assembly for the host
// data pipeline (the port's own copy of
// deeplabv3plus_keras_tpu/native/fastloader.cpp).
//
// One C call assembles a whole batch: every sample is decoded by a worker
// thread directly into its canvas slot (JPEG image rows via libjpeg, PNG
// label palette indices via libpng), with no Python-object traffic and the
// GIL released for the entire call (ctypes drops it automatically).  It
// replaces the Python/PIL decode loop of data/pipeline.py (the reference's
// keras.utils.Sequence __getitem__ host path,
// semantic_segmentation.py:1515-1603).
//
// Per-item status codes let Python fall back to the PIL path for anything
// unusual (oversized inputs that need the SciPy-semantics downscale,
// exotic color spaces, corrupt files), so numerics are always identical to
// the reference path.
//
// Build: g++ -O2 -fPIC -shared fastloader.cpp -o fastloader.so -ljpeg -lpng
// (see __init__.py).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---- status codes (mirrored in native/__init__.py) ----
constexpr int32_t FL_OK = 0;
constexpr int32_t FL_OVERSIZED = 1;   // long side > canvas: Python downscale path
constexpr int32_t FL_FALLBACK = 2;    // unsupported variant: Python PIL path
constexpr int32_t FL_ERR_OPEN = -1;
constexpr int32_t FL_ERR_DECODE = -2;

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one JPEG into canvas (stride canvas_w*3, RGB). Returns status;
// writes h/w on success or on FL_OVERSIZED (so Python knows the true size).
int32_t decode_jpeg(const char* path, uint8_t* canvas, int canvas_h,
                    int canvas_w, int32_t* out_h, int32_t* out_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return FL_ERR_OPEN;

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return FL_ERR_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);

  // Match PIL: RGB output, default (ISLOW) IDCT, no fancy options.
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  *out_h = h;
  *out_w = w;
  if (cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return FL_FALLBACK;
  }
  if (h > canvas_h || w > canvas_w) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return FL_OVERSIZED;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = canvas + size_t(cinfo.output_scanline) * canvas_w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return FL_OK;
}

// Decode one label PNG into canvas (stride canvas_w, 1 byte/pixel).
// Palette PNGs yield raw palette indices (the VOC id coding — identical to
// np.asarray(Image.open(p)) on a mode-P image); grayscale yields gray
// values; RGB/RGBA labels take channel 0 (pipeline.load_sample semantics).
// Pixels equal to 1 are remapped to `remap` when remap >= 0 (Open Images,
// reference :1358-1359).
int32_t decode_png_label(const char* path, uint8_t* canvas, int canvas_h,
                         int canvas_w, int32_t remap, int32_t* out_h,
                         int32_t* out_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return FL_ERR_OPEN;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(f);
    return FL_ERR_DECODE;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return FL_ERR_DECODE;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  const int w = png_get_image_width(png, info);
  const int h = png_get_image_height(png, info);
  const int depth = png_get_bit_depth(png, info);
  *out_h = h;
  *out_w = w;
  if (png_get_interlace_type(png, info) != PNG_INTERLACE_NONE) {
    // png_read_row cannot stream Adam7 rows; rare for labels — PIL path.
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return FL_FALLBACK;
  }
  if (h > canvas_h || w > canvas_w) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return FL_OVERSIZED;
  }

  // Normalize to 1..4 bytes/pixel at 8 bits/channel, keeping palette
  // indices unexpanded.  16-bit labels go to the PIL path: numpy's cast
  // takes the LOW byte while png_set_strip_16 would take the high one.
  if (depth == 16) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return FL_FALLBACK;
  }
  if (depth < 8) png_set_packing(png);  // 1/2/4-bit -> 1 byte/pixel
  png_read_update_info(png, info);
  const int channels = png_get_channels(png, info);
  if (channels < 1 || channels > 4) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return FL_FALLBACK;
  }

  std::vector<uint8_t> rowbuf(size_t(w) * channels);
  for (int y = 0; y < h; ++y) {
    png_read_row(png, rowbuf.data(), nullptr);
    uint8_t* dst = canvas + size_t(y) * canvas_w;
    if (channels == 1) {
      std::memcpy(dst, rowbuf.data(), w);
    } else {
      for (int x = 0; x < w; ++x) dst[x] = rowbuf[size_t(x) * channels];
    }
    if (remap >= 0) {
      const uint8_t rv = static_cast<uint8_t>(remap);
      for (int x = 0; x < w; ++x)
        if (dst[x] == 1) dst[x] = rv;
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return FL_OK;
}

}  // namespace

extern "C" {

// Assemble a batch: for each item i, decode img_paths[i] into
// img_canvas[i] (canvas_h x canvas_w x 3, pre-zeroed by the caller) and, if
// lab_paths[i] != NULL, decode it into lab_canvas[i] (canvas_h x canvas_w).
// sizes[i] = (h, w); status[i]: FL_OK, or FL_OVERSIZED / FL_FALLBACK /
// FL_ERR_* meaning the caller must handle item i itself.  Always returns 0.
int fl_assemble_batch(const char** img_paths, const char** lab_paths,
                      const int32_t* lab_remap, int n, int canvas_h,
                      int canvas_w, uint8_t* img_canvas, uint8_t* lab_canvas,
                      int32_t* sizes, int32_t* status, int nthreads) {
  const size_t img_stride = size_t(canvas_h) * canvas_w * 3;
  const size_t lab_stride = size_t(canvas_h) * canvas_w;

  auto work = [&](int i) {
    int32_t h = 0, w = 0;
    int32_t st = decode_jpeg(img_paths[i], img_canvas + size_t(i) * img_stride,
                             canvas_h, canvas_w, &h, &w);
    if (st == FL_OK && lab_paths && lab_paths[i] && lab_canvas) {
      int32_t lh = 0, lw = 0;
      int32_t lst = decode_png_label(
          lab_paths[i], lab_canvas + size_t(i) * lab_stride, canvas_h,
          canvas_w, lab_remap ? lab_remap[i] : -1, &lh, &lw);
      if (lst == FL_OK && (lh != h || lw != w)) {
        // label/image dimension mismatch: the Python path raises loudly
        // on paste; silently cropping with the image's (h, w) would train
        // on misaligned labels.
        lst = FL_FALLBACK;
      }
      if (lst != FL_OK) st = lst;
    }
    sizes[2 * i] = h;
    sizes[2 * i + 1] = w;
    status[i] = st;
  };

  int T = nthreads < 1 ? 1 : nthreads;
  if (T > n) T = n;
  if (T <= 1) {
    for (int i = 0; i < n; ++i) work(i);
    return 0;
  }
  std::vector<std::thread> pool;
  pool.reserve(T);
  for (int t = 0; t < T; ++t)
    pool.emplace_back([&, t]() {
      for (int i = t; i < n; i += T) work(i);
    });
  for (auto& th : pool) th.join();
  return 0;
}

int fl_abi_version() { return 1; }

}  // extern "C"
