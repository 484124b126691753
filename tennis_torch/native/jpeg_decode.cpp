// Scaled JPEG decode via the system libjpeg-turbo (RGB out, M/8 DCT scaling).
//
// The host input pipeline is decode-bound (~9.5 ms per 720p frame per core;
// geometry is ~2 ms — see README "Host input pipeline"). libjpeg-turbo can
// apply an M/8 scale factor DURING the IDCT, producing e.g. a 630×1120 image
// from a 720×1280 JPEG with a 7-point IDCT — cheaper than full decode and it
// removes ~23% of the downstream resize work. The decode target is the
// smallest M/8 scale whose SHORT side still covers the geometry stage's input
// requirement (data_shape+32 for Resize+CenterCrop, reference train.py:143-147),
// so no upscaling is ever introduced. Output is RGB directly (JCS_EXT_RGB),
// which also removes the cv2 BGR→RGB conversion pass.
//
// Plays the role of the reference's in-dependency decode path (OpenCV imread
// inside MXNet loader workers, reference dataset.py:219-227); compiled here
// because the Python-level loader is thread-parallel and cv2's imread cannot
// scale by 7/8 (only 1/2^k) or skip the BGR intermediate.
//
// C ABI (ctypes-bound in tennis_torch/native/jpeg.py):
//   tjp_dims(data, len, min_short, &h, &w, &scale_num) -> 0 ok
//      header-only parse; picks the smallest M in 1..8 with
//      ceil(short*M/8) >= min_short (min_short <= 0 means full size) and
//      reports the scaled output dims.
//   tjp_decode(data, len, scale_num, out, out_cap, &h, &w) -> 0 ok
//      full decode at scale_num/8 into out (tight HxWx3, RGB).

#include <csetjmp>
#include <cstddef>
#include <cstdio>
#include <cstring>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* mgr = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(mgr->jump, 1);
}

void silence_output(j_common_ptr) {}

int pick_scale(int h, int w, int min_short) {
  // Only the power-of-two IDCT sizes have SIMD kernels in libjpeg-turbo;
  // intermediate M/8 scales fall back to scalar C and measured SLOWER than a
  // full decode (7/8 of a 720p frame: 6.6 ms vs 3.8 ms full — see README).
  if (min_short <= 0) return 8;
  int short_side = h < w ? h : w;
  const int simd_scales[] = {1, 2, 4};
  for (int m : simd_scales) {
    long scaled = (static_cast<long>(short_side) * m + 7) / 8;
    if (scaled >= min_short) return m;
  }
  return 8;
}

}  // namespace

extern "C" {

int tjp_dims(const unsigned char* data, size_t len, int min_short, int* out_h,
             int* out_w, int* out_scale) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  err.pub.output_message = silence_output;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  int scale = pick_scale(cinfo.image_height, cinfo.image_width, min_short);
  cinfo.scale_num = scale;
  cinfo.scale_denom = 8;
  jpeg_calc_output_dimensions(&cinfo);
  *out_h = cinfo.output_height;
  *out_w = cinfo.output_width;
  *out_scale = scale;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int tjp_decode(const unsigned char* data, size_t len, int scale_num,
               unsigned char* out, long out_cap, int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  err.pub.output_message = silence_output;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.scale_num = scale_num;
  cinfo.scale_denom = 8;
  cinfo.out_color_space = JCS_EXT_RGB;  // skip the BGR intermediate entirely
  jpeg_start_decompress(&cinfo);
  const long row = static_cast<long>(cinfo.output_width) * 3;
  if (row * cinfo.output_height > out_cap) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW rows[4];
    int avail = 0;
    for (; avail < 4 && cinfo.output_scanline + avail < cinfo.output_height;
         ++avail) {
      rows[avail] = out + row * (cinfo.output_scanline + avail);
    }
    jpeg_read_scanlines(&cinfo, rows, avail);
  }
  *out_h = cinfo.output_height;
  *out_w = cinfo.output_width;
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
