// Host image IO of stcd_tpu_torch: JPEG/PNG decode and a thread-pooled batch
// collate, with no Python object and no interpreter lock involved.
//
// libjpeg and libpng decode straight into the caller's preallocated numpy
// buffer, and a std::thread fan-out decodes and collates a whole batch in one
// call. Python binds it with ctypes (stcd_tpu_torch/native/__init__.py) and
// reads a file with PIL instead when its format is not JPEG or PNG (TIFF,
// BMP, CMYK JPEG) or when the library could not be built.
//
// Error contract (all functions): 0 = OK, -1 = open failed / unsupported
// magic, -2 = decode error, -3 = dimension/channel mismatch with the
// caller's buffer. No exceptions cross the C ABI; libjpeg errors are
// trapped with setjmp, libpng via the simplified-API error field.
//
// Pixel parity: PNG output matches PIL convert("RGB") exactly (alpha is
// STRIPPED, not composited: RGBA is read and A dropped, which is what PIL
// does). JPEG output equals PIL's when PIL links the same libjpeg-turbo
// generation (tests/test_torch_native_io.py pins both).

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

enum Fmt { FMT_NONE = 0, FMT_JPEG, FMT_PNG };

Fmt sniff(FILE* f) {
  unsigned char magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  if (n >= 3 && magic[0] == 0xFF && magic[1] == 0xD8 && magic[2] == 0xFF)
    return FMT_JPEG;
  static const unsigned char png_magic[8] = {0x89, 'P', 'N', 'G',
                                             0x0D, 0x0A, 0x1A, 0x0A};
  if (n == 8 && memcmp(magic, png_magic, 8) == 0) return FMT_PNG;
  return FMT_NONE;
}

struct JErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jerr_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JErr*>(cinfo->err)->jb, 1);
}

void jerr_silent(j_common_ptr, int) {}

// ---- JPEG ----------------------------------------------------------------

int jpeg_dims(FILE* f, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  jerr.pub.emit_message = jerr_silent;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int jpeg_decode_rgb(FILE* f, uint8_t* out, int oh, int ow) {
  jpeg_decompress_struct cinfo;
  JErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  jerr.pub.emit_message = jerr_silent;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;  // includes CMYK/broken streams -> caller falls back to PIL
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // YCbCr + grayscale convert in-decoder
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != oh ||
      static_cast<int>(cinfo.output_width) != ow ||
      cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * ow * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ---- PNG -----------------------------------------------------------------

int png_dims(const char* path, int* h, int* w) {
  png_image image;
  memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) {
    png_image_free(&image);
    return -2;
  }
  *h = static_cast<int>(image.height);
  *w = static_cast<int>(image.width);
  png_image_free(&image);
  return 0;
}

int png_decode_rgb(const char* path, uint8_t* out, int oh, int ow) {
  png_image image;
  memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) {
    png_image_free(&image);
    return -2;
  }
  if (static_cast<int>(image.height) != oh ||
      static_cast<int>(image.width) != ow) {
    png_image_free(&image);
    return -3;
  }
  // Read RGBA and strip alpha: PIL convert("RGB") DROPS alpha rather than
  // compositing, and the simplified-API RGB format would composite.
  image.format = PNG_FORMAT_RGBA;
  std::vector<uint8_t> rgba(static_cast<size_t>(oh) * ow * 4);
  if (!png_image_finish_read(&image, nullptr, rgba.data(), ow * 4, nullptr)) {
    png_image_free(&image);
    return -2;
  }
  const uint8_t* src = rgba.data();
  uint8_t* dst = out;
  for (size_t i = 0, n = static_cast<size_t>(oh) * ow; i < n; ++i) {
    dst[0] = src[0];
    dst[1] = src[1];
    dst[2] = src[2];
    dst += 3;
    src += 4;
  }
  return 0;
}

int decode_one(const char* path, uint8_t* out, int h, int w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Fmt fmt = sniff(f);
  int rc;
  switch (fmt) {
    case FMT_JPEG:
      rc = jpeg_decode_rgb(f, out, h, w);
      break;
    case FMT_PNG:
      fclose(f);
      return png_decode_rgb(path, out, h, w);
    default:
      rc = -1;
  }
  fclose(f);
  return rc;
}

}  // namespace

extern "C" {

// Probe (height, width); rc per the error contract above.
int stcd_image_dims(const char* path, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Fmt fmt = sniff(f);
  int rc;
  switch (fmt) {
    case FMT_JPEG:
      rc = jpeg_dims(f, h, w);
      break;
    case FMT_PNG:
      fclose(f);
      return png_dims(path, h, w);
    default:
      rc = -1;
  }
  fclose(f);
  return rc;
}

// Decode one image as RGB8 into out[h*w*3].
int stcd_decode_rgb(const char* path, uint8_t* out, int h, int w) {
  return decode_one(path, out, h, w);
}

// Decode n same-sized images into out[n*h*w*3] with a native thread pool
// (no GIL): status[i] gets each file's rc.  Returns the number of
// failures (0 = whole batch OK).
int stcd_decode_rgb_batch(const char** paths, int n, uint8_t* out, int h,
                          int w, int nthreads, int* status) {
  if (n <= 0) return 0;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = n;
  std::atomic<int> next(0), failures(0);
  const size_t stride = static_cast<size_t>(h) * w * 3;
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      int rc = decode_one(paths[i], out + stride * i, h, w);
      status[i] = rc;
      if (rc != 0) failures.fetch_add(1);
    }
  };
  if (nthreads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

int stcd_io_abi_version() { return 1; }

}  // extern "C"
