// Writes an arithmetic-coded JPEG (SOF9, or SOF10 with libjpeg's simple
// progression) with libjpeg, for tests/make_codec_fixtures.py: no tool on a
// machine without cjpeg writes such files.  A fixture maker, not part of
// the port.  Built and run by make_codec_fixtures.py:
//
//   g++ -O2 make_arith_jpeg.cpp -ljpeg -o make_arith_jpeg
//   make_arith_jpeg OUT W H C QUALITY PROGRESSIVE RESTART DC_L DC_U AC_K < raw
//
// raw: H * W * C bytes, C = 3 (RGB, written as YCbCr 4:2:0) or 1 (gray).
// DC_L, DC_U and AC_K condition the coder (jpeglib.h's arith_dc_L,
// arith_dc_U, arith_ac_K) for every table; libjpeg writes them in DAC.

#include <cstdio>
#include <cstdlib>
#include <vector>

#include <jpeglib.h>

int main(int argc, char** argv) {
  if (argc != 11) {
    std::fprintf(stderr, "usage: %s OUT W H C QUALITY PROGRESSIVE RESTART "
                 "DC_L DC_U AC_K < raw\n", argv[0]);
    return 2;
  }
  const int w = std::atoi(argv[2]), h = std::atoi(argv[3]);
  const int ch = std::atoi(argv[4]);
  std::vector<unsigned char> raw(static_cast<size_t>(w) * h * ch);
  if (std::fread(raw.data(), 1, raw.size(), stdin) != raw.size()) return 1;
  FILE* out = std::fopen(argv[1], "wb");
  if (out == nullptr) return 1;
  jpeg_compress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = ch;
  cinfo.in_color_space = ch == 3 ? JCS_RGB : JCS_GRAYSCALE;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, std::atoi(argv[5]), TRUE);
  if (std::atoi(argv[6])) jpeg_simple_progression(&cinfo);
  cinfo.arith_code = TRUE;
  cinfo.restart_interval = std::atoi(argv[7]);
  for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
    cinfo.arith_dc_L[t] = static_cast<UINT8>(std::atoi(argv[8]));
    cinfo.arith_dc_U[t] = static_cast<UINT8>(std::atoi(argv[9]));
    cinfo.arith_ac_K[t] = static_cast<UINT8>(std::atoi(argv[10]));
  }
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = raw.data() + static_cast<size_t>(cinfo.next_scanline) * w * ch;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  std::fclose(out);
  return 0;
}
