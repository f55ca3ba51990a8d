// WebP decoder of the port, in plain C++17 with no library: the
// counterpart of vision_tpu's vtpu_decode_webp (vision_tpu/csrc/
// image_codecs.cpp), which calls libwebp's WebPDecodeRGBA, and of its
// Pillow fallback for animations. The machine with the card has neither,
// so the port carries its own decoder, built to give libwebp's bytes:
//
//   * the RIFF container: simple "VP8 " and "VP8L" files, extended "VP8X"
//     files with an "ALPH" chunk (ICCP, EXIF, XMP and unknown chunks are
//     skipped), and a raw VP8 / VP8L bitstream without a container; sizes
//     are checked as libwebp checks them (a RIFF or chunk size beyond the
//     data is a truncated stream);
//   * VP8 key frames (RFC 6386): the boolean decoder, segmentation and its
//     map, the simple and normal loop filters with per-segment levels,
//     sharpness and mode deltas, 1/2/4/8 token partitions, quantiser
//     indices and deltas, probability updates and the skip flag, the
//     16x16, ten 4x4 and chroma intra modes, the coefficient token tree
//     with its contexts, the inverse WHT and DCT; libwebp's integer
//     arithmetic throughout, so the YUV planes are its planes;
//   * YUV 4:2:0 to RGB as WebPDecodeRGBA gives it: libwebp's "fancy"
//     upsampler (chroma interpolated between row pairs with its rounding)
//     and its 14-bit fixed-point conversion;
//   * VP8L lossless: the predictor (14 modes), cross-colour, subtract-green
//     and colour-indexing (pixel bundling) transforms, the colour cache,
//     meta prefix codes, simple and normal code-length codes, LZ77 copies
//     with the 120-entry distance map;
//   * ALPH: raw or VP8L-compressed (its green channel), filters none,
//     horizontal, vertical and gradient undone; the pre-processing flag
//     changes nothing, since WebPDecodeRGBA does not dither;
//   * animations, which WebPDecodeRGBA refuses and vision_tpu hands to
//     Pillow (WebPAnimDecoder): the first ANMF frame decoded onto a
//     transparent black canvas at its offset, as that decoder leaves the
//     first frame.
//
// The tables below are the format's own (RFC 6386 sections 9.6, 11.5,
// 13.4, 13.5 and 14.1; the VP8L distance map of the WebP lossless
// specification section 4.2.2).
//
// C ABI (bound with ctypes by vision_tpu_torch/io/_image_codecs.py):
//   vt_decode_webp(data, len, &pixels, &h, &w, &c, err, errlen)
//       -> 0 and a malloc'd (h, w, c) uint8 buffer (c = 4, RGBA, not
//       premultiplied; an animation's first frame c = 3 when its VP8X
//       header has no alpha flag, as Pillow gives it), or -1 and the
//       reason in `err`, or -2 out of memory;
//   vt_webp_free frees the buffer.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -ffp-contract=off webp_codec.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

struct DecodeError {
  const char* what;
};

[[noreturn]] void fail(const char* what) { throw DecodeError{what}; }

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | ((uint32_t)p[3] << 24); }

inline int clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// 4x4 intra mode probabilities on a key frame, [above][left] (RFC 6386
// section 11.5, in libwebp's mode order)
const uint8_t kBModesProba[10][10][9] = {
  {
    {231, 120, 48, 89, 115, 113, 120, 152, 112},
    {152, 179, 64, 126, 170, 118, 46, 70, 95},
    {175, 69, 143, 80, 85, 82, 72, 155, 103},
    {56, 58, 10, 171, 218, 189, 17, 13, 152},
    {114, 26, 17, 163, 44, 195, 21, 10, 173},
    {121, 24, 80, 195, 26, 62, 44, 64, 85},
    {144, 71, 10, 38, 171, 213, 144, 34, 26},
    {170, 46, 55, 19, 136, 160, 33, 206, 71},
    {63, 20, 8, 114, 114, 208, 12, 9, 226},
    {81, 40, 11, 96, 182, 84, 29, 16, 36}},
  {
    {134, 183, 89, 137, 98, 101, 106, 165, 148},
    {72, 187, 100, 130, 157, 111, 32, 75, 80},
    {66, 102, 167, 99, 74, 62, 40, 234, 128},
    {41, 53, 9, 178, 241, 141, 26, 8, 107},
    {74, 43, 26, 146, 73, 166, 49, 23, 157},
    {65, 38, 105, 160, 51, 52, 31, 115, 128},
    {104, 79, 12, 27, 217, 255, 87, 17, 7},
    {87, 68, 71, 44, 114, 51, 15, 186, 23},
    {47, 41, 14, 110, 182, 183, 21, 17, 194},
    {66, 45, 25, 102, 197, 189, 23, 18, 22}},
  {
    {88, 88, 147, 150, 42, 46, 45, 196, 205},
    {43, 97, 183, 117, 85, 38, 35, 179, 61},
    {39, 53, 200, 87, 26, 21, 43, 232, 171},
    {56, 34, 51, 104, 114, 102, 29, 93, 77},
    {39, 28, 85, 171, 58, 165, 90, 98, 64},
    {34, 22, 116, 206, 23, 34, 43, 166, 73},
    {107, 54, 32, 26, 51, 1, 81, 43, 31},
    {68, 25, 106, 22, 64, 171, 36, 225, 114},
    {34, 19, 21, 102, 132, 188, 16, 76, 124},
    {62, 18, 78, 95, 85, 57, 50, 48, 51}},
  {
    {193, 101, 35, 159, 215, 111, 89, 46, 111},
    {60, 148, 31, 172, 219, 228, 21, 18, 111},
    {112, 113, 77, 85, 179, 255, 38, 120, 114},
    {40, 42, 1, 196, 245, 209, 10, 25, 109},
    {88, 43, 29, 140, 166, 213, 37, 43, 154},
    {61, 63, 30, 155, 67, 45, 68, 1, 209},
    {100, 80, 8, 43, 154, 1, 51, 26, 71},
    {142, 78, 78, 16, 255, 128, 34, 197, 171},
    {41, 40, 5, 102, 211, 183, 4, 1, 221},
    {51, 50, 17, 168, 209, 192, 23, 25, 82}},
  {
    {138, 31, 36, 171, 27, 166, 38, 44, 229},
    {67, 87, 58, 169, 82, 115, 26, 59, 179},
    {63, 59, 90, 180, 59, 166, 93, 73, 154},
    {40, 40, 21, 116, 143, 209, 34, 39, 175},
    {47, 15, 16, 183, 34, 223, 49, 45, 183},
    {46, 17, 33, 183, 6, 98, 15, 32, 183},
    {57, 46, 22, 24, 128, 1, 54, 17, 37},
    {65, 32, 73, 115, 28, 128, 23, 128, 205},
    {40, 3, 9, 115, 51, 192, 18, 6, 223},
    {87, 37, 9, 115, 59, 77, 64, 21, 47}},
  {
    {104, 55, 44, 218, 9, 54, 53, 130, 226},
    {64, 90, 70, 205, 40, 41, 23, 26, 57},
    {54, 57, 112, 184, 5, 41, 38, 166, 213},
    {30, 34, 26, 133, 152, 116, 10, 32, 134},
    {39, 19, 53, 221, 26, 114, 32, 73, 255},
    {31, 9, 65, 234, 2, 15, 1, 118, 73},
    {75, 32, 12, 51, 192, 255, 160, 43, 51},
    {88, 31, 35, 67, 102, 85, 55, 186, 85},
    {56, 21, 23, 111, 59, 205, 45, 37, 192},
    {55, 38, 70, 124, 73, 102, 1, 34, 98}},
  {
    {125, 98, 42, 88, 104, 85, 117, 175, 82},
    {95, 84, 53, 89, 128, 100, 113, 101, 45},
    {75, 79, 123, 47, 51, 128, 81, 171, 1},
    {57, 17, 5, 71, 102, 57, 53, 41, 49},
    {38, 33, 13, 121, 57, 73, 26, 1, 85},
    {41, 10, 67, 138, 77, 110, 90, 47, 114},
    {115, 21, 2, 10, 102, 255, 166, 23, 6},
    {101, 29, 16, 10, 85, 128, 101, 196, 26},
    {57, 18, 10, 102, 102, 213, 34, 20, 43},
    {117, 20, 15, 36, 163, 128, 68, 1, 26}},
  {
    {102, 61, 71, 37, 34, 53, 31, 243, 192},
    {69, 60, 71, 38, 73, 119, 28, 222, 37},
    {68, 45, 128, 34, 1, 47, 11, 245, 171},
    {62, 17, 19, 70, 146, 85, 55, 62, 70},
    {37, 43, 37, 154, 100, 163, 85, 160, 1},
    {63, 9, 92, 136, 28, 64, 32, 201, 85},
    {75, 15, 9, 9, 64, 255, 184, 119, 16},
    {86, 6, 28, 5, 64, 255, 25, 248, 1},
    {56, 8, 17, 132, 137, 255, 55, 116, 128},
    {58, 15, 20, 82, 135, 57, 26, 121, 40}},
  {
    {164, 50, 31, 137, 154, 133, 25, 35, 218},
    {51, 103, 44, 131, 131, 123, 31, 6, 158},
    {86, 40, 64, 135, 148, 224, 45, 183, 128},
    {22, 26, 17, 131, 240, 154, 14, 1, 209},
    {45, 16, 21, 91, 64, 222, 7, 1, 197},
    {56, 21, 39, 155, 60, 138, 23, 102, 213},
    {83, 12, 13, 54, 192, 255, 68, 47, 28},
    {85, 26, 85, 85, 128, 128, 32, 146, 171},
    {18, 11, 7, 63, 144, 171, 4, 4, 246},
    {35, 27, 10, 146, 174, 171, 12, 26, 128}},
  {
    {190, 80, 35, 99, 180, 80, 126, 54, 45},
    {85, 126, 47, 87, 176, 51, 41, 20, 32},
    {101, 75, 128, 139, 118, 146, 116, 128, 85},
    {56, 41, 15, 176, 236, 85, 37, 9, 62},
    {71, 30, 17, 119, 118, 255, 17, 18, 138},
    {101, 38, 60, 138, 55, 70, 43, 26, 142},
    {146, 36, 19, 30, 171, 255, 97, 27, 20},
    {138, 45, 61, 62, 219, 1, 81, 188, 64},
    {32, 41, 20, 117, 151, 142, 20, 21, 163},
    {112, 19, 12, 61, 195, 128, 48, 4, 24}}};

// the 4x4 intra mode tree: an index i > 0 reads bit prob[i] and goes on
// at 2i + bit; a value <= 0 is a mode
const int8_t kYModesIntra4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9};

// default coefficient probabilities (RFC 6386 section 13.5)
const uint8_t kCoeffsProba0[4][8][3][11] = {
  {
    {
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    {
      {253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
      {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
      {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
    {
      {1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
      {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
      {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
    {
      {1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
      {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
      {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
    {
      {1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
      {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
      {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
    {
      {1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
      {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
      {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
    {
      {1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
      {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
      {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
    {
      {1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
  {
    {
      {198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
      {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
      {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
    {
      {1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
      {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
      {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
    {
      {1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
      {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
      {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
    {
      {1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
      {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
      {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
    {
      {1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
      {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
      {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
    {
      {1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
      {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
      {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
    {
      {1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
      {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
      {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
    {
      {1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
      {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
  {
    {
      {253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
      {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
      {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
    {
      {1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
      {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
      {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
    {
      {1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
      {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
      {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
    {
      {1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
      {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
      {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
    {
      {1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
      {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {
      {1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {
      {1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
      {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
      {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
  {
    {
      {202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
      {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
      {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
    {
      {1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
      {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
      {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
    {
      {1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
      {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
      {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
    {
      {1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
      {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
      {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
    {
      {1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
      {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
      {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
    {
      {1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
      {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
      {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
    {
      {1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
      {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
      {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
    {
      {1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};

// their update probabilities (RFC 6386 section 13.4)
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  {
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
      {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
  {
    {
      {217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
      {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
    {
      {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
  {
    {
      {186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
      {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
    {
      {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
    {
      {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
  {
    {
      {248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
    {
      {255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};

// coefficient position -> band; the 17th entry a sentinel
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};

// dequantisation (RFC 6386 section 14.1)
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// the extra-bit probabilities of token categories 3 to 6
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// VP8L: the order of the code-length code lengths, and the 2-D
// neighbourhood of the first 120 distance codes (dy << 4 | (8 - dx))
const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57,
    21, 27, 54, 58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74,
    36, 44, 88, 69, 75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30, 102, 106, 34, 46,
    84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114,
    126, 97, 111, 80, 113, 127, 96, 112,
};


// ------------------------------------------------------------ VP8 lossy

// RFC 6386 section 7's boolean decoder. `eof` turns true as libwebp's
// VP8BitReader turns it: when a decision needs a byte past the end.
struct BoolDecoder {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint32_t value = 0;
  uint32_t range = 255;
  int bit_count = 0;
  uint64_t shifts = 0;  // bits shifted out so far
  uint64_t nbits = 0;   // 8 * length
  bool eof = false;

  void init(const uint8_t* data, size_t n) {
    p = data;
    end = data + n;
    nbits = 8ull * n;
    value = (next() << 8) | next();
    range = 255;
    bit_count = 0;
    shifts = 0;
    eof = false;
  }
  uint32_t next() { return p < end ? *p++ : 0; }
  int get(int prob) {
    if (shifts + 8 > nbits) eof = true;
    const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    const uint32_t big_split = split << 8;
    int bit;
    if (value >= big_split) {
      bit = 1;
      range -= split;
      value -= big_split;
    } else {
      bit = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      ++shifts;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next();
      }
    }
    return bit;
  }
  int flag() { return get(128); }
  int literal(int n) {
    int v = 0;
    while (n-- > 0) v |= flag() << n;
    return v;
  }
  int signed_literal(int n) {
    const int v = literal(n);
    return flag() ? -v : v;
  }
};

// libwebp's intra mode numbers (dec/common_dec.h): the 16x16 and chroma
// modes share the first four with the 4x4 modes.
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
enum { DC_PRED = 0, TM_PRED, V_PRED, H_PRED,
       DC_NOTOP = 4, DC_NOLEFT, DC_NOTOPLEFT };

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct FilterInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0, inner = 0;
};

struct MacroBlock {
  int segment = 0;
  int skip = 0;
  int is_i4x4 = 0;
  uint8_t imodes[16];
  int uvmode = 0;
  int16_t coeffs[384];
};

constexpr int BPS = 32;  // work buffer stride, as libwebp's

// ---- prediction (libwebp dsp/dec.c, on a work buffer of stride BPS)

inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = (uint8_t)clip8(top[x] + left - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) memset(dst + y * BPS, v, size);
}

void predict_block(uint8_t* dst, int size, int mode) {
  // 16x16 luma (size 16) and 8x8 chroma (size 8) modes
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-BPS + j] + dst[-1 + j * BPS];
      fill(dst, size, dc >> (shift + 1));
      break;
    }
    case TM_PRED:
      true_motion(dst, size);
      break;
    case V_PRED:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, size, dc >> shift);
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-BPS + j];
      fill(dst, size, dc >> shift);
      break;
    }
    default:  // DC_NOTOPLEFT
      fill(dst, size, 0x80);
      break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS], X = top[-1];
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
            F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) memset(dst + i * BPS, dc, 4);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                               avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE:
      memset(dst + 0 * BPS, avg3(X, I, J), 4);
      memset(dst + 1 * BPS, avg3(I, J, K), 4);
      memset(dst + 2 * BPS, avg3(J, K, L), 4);
      memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}

#undef DST

// ---- inverse transforms (libwebp dsp/dec.c TransformOne_C, TransformWHT_C)

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void idct_add(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = (uint8_t)clip8(dst[0] + ((a + d) >> 3));
    dst[1] = (uint8_t)clip8(dst[1] + ((b + c) >> 3));
    dst[2] = (uint8_t)clip8(dst[2] + ((b - c) >> 3));
    dst[3] = (uint8_t)clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

void inverse_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// ---- loop filters (libwebp dsp/dec.c, RFC 6386 section 15)

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = (uint8_t)clip8(p0 + a2);
  p[0] = (uint8_t)clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = (uint8_t)clip8(p1 + a3);
  p[-step] = (uint8_t)clip8(p0 + a2);
  p[0] = (uint8_t)clip8(q0 - a1);
  p[step] = (uint8_t)clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = (uint8_t)clip8(p2 + a3);
  p[-2 * step] = (uint8_t)clip8(p1 + a2);
  p[-step] = (uint8_t)clip8(p0 + a1);
  p[0] = (uint8_t)clip8(q0 - a1);
  p[step] = (uint8_t)clip8(q1 - a2);
  p[2 * step] = (uint8_t)clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return false;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
         abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

// `hstride` crosses the edge, `vstride` walks along it
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i) {
    if (needs_filter(p + i * vstride, hstride, thresh2)) do_filter2(p + i * vstride, hstride);
  }
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_thresh, bool mb_edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else if (mb_edge) {
        do_filter6(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

// ---- the frame

struct Vp8Frame {
  int width = 0, height = 0;
  int mb_w = 0, mb_h = 0;
  // planes of whole macroblocks
  std::vector<uint8_t> y, u, v;
  int y_stride = 0, uv_stride = 0;
};

struct Vp8Decoder {
  BoolDecoder br;
  BoolDecoder parts[8];
  int num_parts = 1;
  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0};
  int filter_strength[4] = {0, 0, 0, 0};
  int segment_proba[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0};
  int mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  QuantMatrix dqm[4];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  FilterInfo fstrengths[4][2];
};

void parse_segment_header(Vp8Decoder& d) {
  BoolDecoder& br = d.br;
  d.use_segment = br.flag();
  if (d.use_segment) {
    d.update_map = br.flag();
    if (br.flag()) {  // update data
      d.absolute_delta = br.flag();
      for (int s = 0; s < 4; ++s) d.quantizer[s] = br.flag() ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; ++s) d.filter_strength[s] = br.flag() ? br.signed_literal(6) : 0;
    }
    if (d.update_map) {
      for (int s = 0; s < 3; ++s) d.segment_proba[s] = br.flag() ? br.literal(8) : 255;
    }
  } else {
    d.update_map = 0;
  }
  if (br.eof) fail("VP8: cannot parse the segment header");
}

void parse_filter_header(Vp8Decoder& d) {
  BoolDecoder& br = d.br;
  d.simple = br.flag();
  d.level = br.literal(6);
  d.sharpness = br.literal(3);
  d.use_lf_delta = br.flag();
  if (d.use_lf_delta) {
    if (br.flag()) {  // update the deltas
      for (int i = 0; i < 4; ++i) if (br.flag()) d.ref_lf_delta[i] = br.signed_literal(6);
      for (int i = 0; i < 4; ++i) if (br.flag()) d.mode_lf_delta[i] = br.signed_literal(6);
    }
  }
  // libwebp filters nothing when the frame's level is 0, whatever the
  // segments' levels
  d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
  if (br.eof) fail("VP8: cannot parse the filter header");
}

void parse_partitions(Vp8Decoder& d, const uint8_t* buf, size_t size) {
  const int last_part = (1 << d.br.literal(2)) - 1;
  d.num_parts = last_part + 1;
  if (size < 3 * (size_t)last_part) fail("VP8: cannot read the partition sizes");
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + last_part * 3;
  size_t size_left = size - last_part * 3;
  for (int p = 0; p < last_part; ++p) {
    size_t psize = le24(sz);
    if (psize > size_left) psize = size_left;
    d.parts[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  d.parts[last_part].init(part_start, size_left);
  if (part_start >= buf + size) fail("VP8: the token partitions are truncated");
}

void parse_quant(Vp8Decoder& d) {
  BoolDecoder& br = d.br;
  const int base_q0 = br.literal(7);
  const int dqy1_dc = br.flag() ? br.signed_literal(4) : 0;
  const int dqy2_dc = br.flag() ? br.signed_literal(4) : 0;
  const int dqy2_ac = br.flag() ? br.signed_literal(4) : 0;
  const int dquv_dc = br.flag() ? br.signed_literal(4) : 0;
  const int dquv_ac = br.flag() ? br.signed_literal(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (d.use_segment) {
      q = d.quantizer[i];
      if (!d.absolute_delta) q += base_q0;
    } else {
      if (i > 0) {
        d.dqm[i] = d.dqm[0];
        continue;
      }
      q = base_q0;
    }
    QuantMatrix& m = d.dqm[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100 for every x of the table, as (x * 101581) >> 16
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void parse_proba(Vp8Decoder& d) {
  BoolDecoder& br = d.br;
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          d.proba[t][b][c][p] = br.get(kCoeffsUpdateProba[t][b][c][p])
                                    ? (uint8_t)br.literal(8)
                                    : kCoeffsProba0[t][b][c][p];
  d.use_skip_proba = br.flag();
  if (d.use_skip_proba) d.skip_p = br.literal(8);
}

void precompute_filter_strengths(Vp8Decoder& d) {
  if (d.filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (d.use_segment) {
      base_level = d.filter_strength[s];
      if (!d.absolute_delta) base_level += d.level;
    } else {
      base_level = d.level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FilterInfo& info = d.fstrengths[s][i4x4];
      int level = base_level;
      if (d.use_lf_delta) {
        level += d.ref_lf_delta[0];
        if (i4x4) level += d.mode_lf_delta[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (d.sharpness > 0) {
          ilevel >>= d.sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * level + ilevel;
        info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
      }
      info.inner = i4x4;
    }
  }
}

void parse_intra_mode(Vp8Decoder& d, MacroBlock& mb, uint8_t* top, uint8_t* left) {
  BoolDecoder& br = d.br;
  if (d.update_map) {
    mb.segment = !br.get(d.segment_proba[0]) ? br.get(d.segment_proba[1])
                                             : br.get(d.segment_proba[2]) + 2;
  } else {
    mb.segment = 0;
  }
  mb.skip = d.use_skip_proba ? br.get(d.skip_p) : 0;
  mb.is_i4x4 = !br.get(145);
  if (!mb.is_i4x4) {
    const int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED)
                                  : (br.get(163) ? V_PRED : DC_PRED);
    mb.imodes[0] = (uint8_t)ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = mb.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        int i = kYModesIntra4[br.get(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
        ymode = -i;
        top[x] = (uint8_t)ymode;
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = (uint8_t)ymode;
    }
  }
  mb.uvmode = !br.get(142) ? DC_PRED : !br.get(114) ? V_PRED : br.get(183) ? TM_PRED : H_PRED;
}

int large_value(BoolDecoder& br, const uint8_t* p) {
  int v;
  if (!br.get(p[3])) {
    if (!br.get(p[4])) {
      v = 2;
    } else {
      v = 3 + br.get(p[5]);
    }
  } else {
    if (!br.get(p[6])) {
      if (!br.get(p[7])) {
        v = 5 + br.get(159);
      } else {
        v = 7 + 2 * br.get(165);
        v += br.get(145);
      }
    } else {
      const int bit1 = br.get(p[8]);
      const int bit0 = br.get(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// the tokens of one block from position n; returns where they stopped
// (libwebp's GetCoeffs)
int get_coeffs(BoolDecoder& br, const uint8_t (*band)[3][11], int ctx,
               const int* dq, int n, int16_t* out) {
  const uint8_t* p = band[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;  // end of block
    while (!br.get(p[1])) {       // a run of zeros
      p = band[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    const uint8_t (*next)[11] = band[kBands[n + 1]];
    if (!br.get(p[2])) {
      v = 1;
      p = next[1];
    } else {
      v = large_value(br, p);
      p = next[2];
    }
    const int sign = br.flag();
    out[kZigzag[n]] = (int16_t)((sign ? -v : v) * dq[n > 0]);
  }
  return 16;
}

// the per-column and per-row non-zero contexts (libwebp's nz_ bits)
struct NzContext {
  uint8_t y[4], u[2], v[2], dc;
};

// libwebp's ParseResiduals: returns whether no block has a coefficient
// past the first, nor a non-zero first one (its `skip`)
bool parse_residuals(Vp8Decoder& d, MacroBlock& mb, BoolDecoder& br,
                     NzContext& top, NzContext& left) {
  const QuantMatrix& q = d.dqm[mb.segment];
  int16_t* dst = mb.coeffs;
  memset(dst, 0, sizeof(mb.coeffs));
  bool any = false;
  int first;
  const uint8_t (*ac_band)[3][11];
  if (!mb.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = top.dc + left.dc;
    const int nz = get_coeffs(br, d.proba[1], ctx, q.y2, 0, dc);
    top.dc = left.dc = nz > 0;
    if (nz > 1) {
      inverse_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 256; i += 16) dst[i] = (int16_t)dc0;
    }
    first = 1;
    ac_band = d.proba[0];
  } else {
    first = 0;
    ac_band = d.proba[3];
  }
  for (int y = 0; y < 4; ++y) {
    int l = left.y[y];
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + top.y[x];
      const int nz = get_coeffs(br, ac_band, ctx, q.y1, first, dst);
      l = nz > first;
      top.y[x] = (uint8_t)l;
      if (nz > 1 || dst[0] != 0) any = true;  // libwebp's NzCodeBits
      dst += 16;
    }
    left.y[y] = (uint8_t)l;
  }
  for (int ch = 0; ch < 2; ++ch) {
    uint8_t* tnz = ch == 0 ? top.u : top.v;
    uint8_t* lnz = ch == 0 ? left.u : left.v;
    for (int y = 0; y < 2; ++y) {
      int l = lnz[y];
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + tnz[x];
        const int nz = get_coeffs(br, d.proba[2], ctx, q.uv, 0, dst);
        l = nz > 0;
        tnz[x] = (uint8_t)l;
        if (nz > 1 || dst[0] != 0) any = true;
        dst += 16;
      }
      lnz[y] = (uint8_t)l;
    }
  }
  return !any;
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : DC_PRED;
  }
  return mode;
}

bool nonzero(const int16_t* c) {
  for (int i = 0; i < 16; ++i) if (c[i]) return true;
  return false;
}

// reconstruct one macroblock into the frame's (unfiltered) planes, with
// libwebp's edge rules: 127 above the first row, 129 left of the first
// column, the above-right samples of the rightmost 4x4 column from the
// macroblock above and to the right (its last row)
void reconstruct(Vp8Frame& f, const MacroBlock& mb, int mb_x, int mb_y) {
  uint8_t ybuf[BPS * 17], ubuf[BPS * 9], vbuf[BPS * 9];
  uint8_t* const y_dst = ybuf + BPS + 8;
  uint8_t* const u_dst = ubuf + BPS + 8;
  uint8_t* const v_dst = vbuf + BPS + 8;
  const int ys = f.y_stride, cs = f.uv_stride;
  uint8_t* const yp = f.y.data() + (size_t)mb_y * 16 * ys + mb_x * 16;
  uint8_t* const up = f.u.data() + (size_t)mb_y * 8 * cs + mb_x * 8;
  uint8_t* const vp = f.v.data() + (size_t)mb_y * 8 * cs + mb_x * 8;
  // top row, top-left and top-right
  if (mb_y > 0) {
    memcpy(y_dst - BPS, yp - ys, 16);
    memcpy(u_dst - BPS, up - cs, 8);
    memcpy(v_dst - BPS, vp - cs, 8);
    if (mb_x > 0) {
      y_dst[-BPS - 1] = yp[-ys - 1];
      u_dst[-BPS - 1] = up[-cs - 1];
      v_dst[-BPS - 1] = vp[-cs - 1];
    } else {
      y_dst[-BPS - 1] = u_dst[-BPS - 1] = v_dst[-BPS - 1] = 129;
    }
    if (mb_x < f.mb_w - 1) {
      memcpy(y_dst - BPS + 16, yp - ys + 16, 4);
    } else {
      memset(y_dst - BPS + 16, yp[-ys + 15], 4);
    }
  } else {
    memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    memset(u_dst - BPS - 1, 127, 8 + 1);
    memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  // left column
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = mb_x > 0 ? yp[j * ys - 1] : 129;
  for (int j = 0; j < 8; ++j) {
    u_dst[j * BPS - 1] = mb_x > 0 ? up[j * cs - 1] : 129;
    v_dst[j * BPS - 1] = mb_x > 0 ? vp[j * cs - 1] : 129;
  }
  // the top-right samples replicated down the rightmost 4x4 column
  for (int r = 3; r < 12; r += 4) memcpy(y_dst + r * BPS + 16, y_dst - BPS + 16, 4);

  const int16_t* coeffs = mb.coeffs;
  if (mb.is_i4x4) {
    for (int n = 0; n < 16; ++n) {
      uint8_t* const dst = y_dst + (n >> 2) * 4 * BPS + (n & 3) * 4;
      predict4(dst, mb.imodes[n]);
      if (nonzero(coeffs + n * 16)) idct_add(coeffs + n * 16, dst);
    }
  } else {
    predict_block(y_dst, 16, check_mode(mb_x, mb_y, mb.imodes[0]));
    for (int n = 0; n < 16; ++n) {
      uint8_t* const dst = y_dst + (n >> 2) * 4 * BPS + (n & 3) * 4;
      if (nonzero(coeffs + n * 16)) idct_add(coeffs + n * 16, dst);
    }
  }
  const int uvmode = check_mode(mb_x, mb_y, mb.uvmode);
  predict_block(u_dst, 8, uvmode);
  predict_block(v_dst, 8, uvmode);
  for (int n = 0; n < 4; ++n) {
    const int off = (n >> 1) * 4 * BPS + (n & 1) * 4;
    if (nonzero(coeffs + 256 + n * 16)) idct_add(coeffs + 256 + n * 16, u_dst + off);
    if (nonzero(coeffs + 320 + n * 16)) idct_add(coeffs + 320 + n * 16, v_dst + off);
  }
  for (int j = 0; j < 16; ++j) memcpy(yp + j * ys, y_dst + j * BPS, 16);
  for (int j = 0; j < 8; ++j) {
    memcpy(up + j * cs, u_dst + j * BPS, 8);
    memcpy(vp + j * cs, v_dst + j * BPS, 8);
  }
}

void filter_mb(Vp8Frame& f, const Vp8Decoder& d, const FilterInfo& fi, int mb_x, int mb_y) {
  const int limit = fi.limit;
  if (limit == 0) return;
  const int ys = f.y_stride, cs = f.uv_stride;
  uint8_t* const yp = f.y.data() + (size_t)mb_y * 16 * ys + mb_x * 16;
  if (d.filter_type == 1) {  // simple: luma only
    if (mb_x > 0) simple_filter(yp, 1, ys, limit + 4);
    if (fi.inner) for (int i = 4; i < 16; i += 4) simple_filter(yp + i, 1, ys, limit);
    if (mb_y > 0) simple_filter(yp, ys, 1, limit + 4);
    if (fi.inner) for (int i = 4; i < 16; i += 4) simple_filter(yp + i * ys, ys, 1, limit);
    return;
  }
  uint8_t* const up = f.u.data() + (size_t)mb_y * 8 * cs + mb_x * 8;
  uint8_t* const vp = f.v.data() + (size_t)mb_y * 8 * cs + mb_x * 8;
  const int il = fi.ilevel, hev_t = fi.hev_thresh;
  if (mb_x > 0) {
    filter_loop(yp, 1, ys, 16, limit + 4, il, hev_t, true);
    filter_loop(up, 1, cs, 8, limit + 4, il, hev_t, true);
    filter_loop(vp, 1, cs, 8, limit + 4, il, hev_t, true);
  }
  if (fi.inner) {
    for (int i = 4; i < 16; i += 4) filter_loop(yp + i, 1, ys, 16, limit, il, hev_t, false);
    filter_loop(up + 4, 1, cs, 8, limit, il, hev_t, false);
    filter_loop(vp + 4, 1, cs, 8, limit, il, hev_t, false);
  }
  if (mb_y > 0) {
    filter_loop(yp, ys, 1, 16, limit + 4, il, hev_t, true);
    filter_loop(up, cs, 1, 8, limit + 4, il, hev_t, true);
    filter_loop(vp, cs, 1, 8, limit + 4, il, hev_t, true);
  }
  if (fi.inner) {
    for (int i = 4; i < 16; i += 4) filter_loop(yp + i * ys, ys, 1, 16, limit, il, hev_t, false);
    filter_loop(up + 4 * cs, cs, 1, 8, limit, il, hev_t, false);
    filter_loop(vp + 4 * cs, cs, 1, 8, limit, il, hev_t, false);
  }
}

// the 10-byte frame header: checks as VP8GetInfo and VP8GetHeaders do
void vp8_frame_size(const uint8_t* data, size_t size, size_t chunk_size, int* w, int* h) {
  if (size < 10) fail("VP8: the frame header is truncated");
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
    fail("VP8: no key frame start code (a corrupt stream)");
  const uint32_t bits = le24(data);
  if (bits & 1) fail("VP8: not a key frame");
  if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= chunk_size)
    fail("VP8: inconsistent frame header (profile, show flag or partition size)");
  *w = le16(data + 6) & 0x3fff;
  *h = le16(data + 8) & 0x3fff;
  if (*w == 0 || *h == 0) fail("VP8: a frame of zero width or height");
}

void decode_vp8(const uint8_t* data, size_t size, Vp8Frame& f) {
  // `size` runs to the end of the given bytes, as libwebp's io data does
  const uint32_t bits = le24(data);
  const size_t partition_length = bits >> 5;
  f.width = le16(data + 6) & 0x3fff;
  f.height = le16(data + 8) & 0x3fff;
  f.mb_w = (f.width + 15) >> 4;
  f.mb_h = (f.height + 15) >> 4;
  const uint8_t* buf = data + 10;
  size_t buf_size = size - 10;
  if (partition_length > buf_size) fail("VP8: bad partition length");
  Vp8Decoder d;
  d.br.init(buf, partition_length);
  buf += partition_length;
  buf_size -= partition_length;
  d.br.flag();  // colour space
  d.br.flag();  // clamping type
  parse_segment_header(d);
  parse_filter_header(d);
  parse_partitions(d, buf, buf_size);
  parse_quant(d);
  d.br.flag();  // refresh entropy probs: ignored, there is one frame
  parse_proba(d);
  precompute_filter_strengths(d);

  f.y_stride = f.mb_w * 16;
  f.uv_stride = f.mb_w * 8;
  f.y.assign((size_t)f.y_stride * f.mb_h * 16, 0);
  f.u.assign((size_t)f.uv_stride * f.mb_h * 8, 0);
  f.v.assign((size_t)f.uv_stride * f.mb_h * 8, 0);

  std::vector<uint8_t> intra_t(4 * f.mb_w, B_DC);
  std::vector<NzContext> nz_top(f.mb_w);
  memset(nz_top.data(), 0, nz_top.size() * sizeof(NzContext));
  std::vector<MacroBlock> row(f.mb_w);
  std::vector<FilterInfo> finfo((size_t)f.mb_w * f.mb_h);
  for (int mb_y = 0; mb_y < f.mb_h; ++mb_y) {
    uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x)
      parse_intra_mode(d, row[mb_x], &intra_t[4 * mb_x], intra_l);
    if (d.br.eof) fail("VP8: premature end of the first partition");
    BoolDecoder& tbr = d.parts[mb_y & (d.num_parts - 1)];
    NzContext nz_left;
    memset(&nz_left, 0, sizeof(nz_left));
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
      MacroBlock& mb = row[mb_x];
      int skip = d.use_skip_proba ? mb.skip : 0;
      if (!skip) {
        skip = parse_residuals(d, mb, tbr, nz_top[mb_x], nz_left);
      } else {
        memset(mb.coeffs, 0, sizeof(mb.coeffs));
        memset(nz_top[mb_x].y, 0, 4);
        memset(nz_top[mb_x].u, 0, 2);
        memset(nz_top[mb_x].v, 0, 2);
        memset(nz_left.y, 0, 4);
        memset(nz_left.u, 0, 2);
        memset(nz_left.v, 0, 2);
        if (!mb.is_i4x4) nz_top[mb_x].dc = nz_left.dc = 0;
      }
      if (d.filter_type > 0) {
        FilterInfo fi = d.fstrengths[mb.segment][mb.is_i4x4];
        fi.inner |= !skip;
        finfo[(size_t)mb_y * f.mb_w + mb_x] = fi;
      }
      if (tbr.eof) fail("VP8: premature end of a token partition");
      reconstruct(f, mb, mb_x, mb_y);
    }
  }
  // the loop filter runs over the reconstructed frame in macroblock order:
  // prediction reads unfiltered samples, as in libwebp
  if (d.filter_type > 0) {
    for (int mb_y = 0; mb_y < f.mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < f.mb_w; ++mb_x)
        filter_mb(f, d, finfo[(size_t)mb_y * f.mb_w + mb_x], mb_x, mb_y);
  }
}

// ---- YUV 4:2:0 -> RGBA (libwebp dsp/yuv.h, dsp/upsampling.c)

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) { return (v & ~16383) == 0 ? (v >> 6) : v < 0 ? 0 : 255; }

inline void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = (uint8_t)yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgba[2] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  rgba[3] = 0xff;
}

#define LOAD_UV(u, v) ((uint32_t)(u) | ((uint32_t)(v) << 16))

// UpsampleRgbaLinePair: two output rows from the chroma rows above and
// below them; `bottom_y` may be null
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = LOAD_UV(top_u[0], top_v[0]);
  uint32_t l_uv = LOAD_UV(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgba(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y != nullptr) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgba(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = LOAD_UV(top_u[x], top_v[x]);
    const uint32_t uv = LOAD_UV(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgba(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * 4);
      yuv_to_rgba(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + (2 * x) * 4);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgba(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (2 * x - 1) * 4);
      yuv_to_rgba(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16, bottom_dst + (2 * x) * 4);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgba(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * 4);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgba(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * 4);
    }
  }
}

#undef LOAD_UV

// EmitFancyRGB over the whole (cropped) frame: row 0 alone, then pairs
// (2k-1, 2k) between chroma rows k-1 and k, and the last row of an even
// height alone
void frame_to_rgba(const Vp8Frame& f, uint8_t* out) {
  const int w = f.width, h = f.height;
  const size_t stride = (size_t)w * 4;
  const uint8_t* Y = f.y.data();
  const uint8_t* U = f.u.data();
  const uint8_t* V = f.v.data();
  const int ys = f.y_stride, cs = f.uv_stride;
  upsample_pair(Y, nullptr, U, V, U, V, out, nullptr, w);
  int k = 1;
  for (; 2 * k < h; ++k) {
    upsample_pair(Y + (size_t)(2 * k - 1) * ys, Y + (size_t)(2 * k) * ys,
                  U + (size_t)(k - 1) * cs, V + (size_t)(k - 1) * cs,
                  U + (size_t)k * cs, V + (size_t)k * cs,
                  out + (2 * k - 1) * stride, out + (2 * k) * stride, w);
  }
  if (!(h & 1)) {
    const size_t c = (size_t)(h / 2 - 1) * cs;
    upsample_pair(Y + (size_t)(h - 1) * ys, nullptr, U + c, V + c, U + c, V + c,
                  out + (h - 1) * stride, nullptr, w);
  }
}

// ------------------------------------------------------- VP8L lossless

struct BitReader {
  const uint8_t* data = nullptr;
  size_t len = 0;
  uint64_t pos = 0;  // in bits
  void init(const uint8_t* d, size_t n) { data = d; len = n; pos = 0; }
  bool eos() const { return pos > 8ull * len; }
  uint32_t peek(int n) const {  // the next n (<= 24) bits, zeros past the end
    const size_t byte = (size_t)(pos >> 3);
    uint64_t window = 0;
    for (int i = 0; i < 5; ++i)
      if (byte + i < len) window |= (uint64_t)data[byte + i] << (8 * i);
    return (uint32_t)(window >> (pos & 7)) & ((1u << n) - 1);
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    pos += n;
    return v;
  }
};

constexpr int kPrimaryBits = 8;

struct HuffmanCode {
  // canonical code: symbols sorted by (length, symbol)
  std::vector<uint16_t> sorted;
  int count[16] = {0};
  int first_code[16] = {0};
  int first_index[16] = {0};
  // table on the next kPrimaryBits bits (read LSB first): symbol and
  // length, or length 0 where the code is longer
  std::vector<uint16_t> table_symbol;
  std::vector<uint8_t> table_len;
  int single = -1;  // the one symbol of a zero-bit code

  int read(BitReader& br) const {
    if (single >= 0) return single;
    const uint32_t bits = br.peek(kPrimaryBits);
    if (table_len[bits]) {
      br.pos += table_len[bits];
      return table_symbol[bits];
    }
    int code = 0;
    for (int len = 1; len <= 15; ++len) {
      code = (code << 1) | (int)br.read(1);
      const int offset = code - first_code[len];
      if (offset >= 0 && offset < count[len]) return sorted[first_index[len] + offset];
    }
    fail("VP8L: invalid prefix code");
  }
};

// VP8LBuildHuffmanTable's checks: lengths of at most 15, not all zero, a
// complete code unless a single symbol is coded
void build_code(const std::vector<int>& lengths, HuffmanCode& code) {
  const int n = (int)lengths.size();
  int count[16] = {0};
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > 15) fail("VP8L: a code length above 15");
    ++count[lengths[s]];
  }
  if (count[0] == n) fail("VP8L: a prefix code with no symbol");
  int offset[17];
  offset[1] = 0;
  for (int len = 1; len < 15; ++len) {
    if (count[len] > (1 << len)) fail("VP8L: an invalid prefix code");
    offset[len + 1] = offset[len] + count[len];
  }
  code.sorted.assign(n - count[0], 0);
  {
    int off[16];
    int k = 0;
    for (int len = 1; len <= 15; ++len) { off[len] = k; k += count[len]; }
    for (int s = 0; s < n; ++s)
      if (lengths[s] > 0) code.sorted[off[lengths[s]]++] = (uint16_t)s;
  }
  if (offset[15] == 1) {  // one symbol of length below 15: zero bits
    int s = 0;
    while (lengths[s] == 0 || lengths[s] == 15) ++s;
    code.single = s;
    return;
  }
  int open = 1;
  for (int len = 1; len <= 15; ++len) {
    open <<= 1;
    open -= count[len];
    if (open < 0) fail("VP8L: an over-subscribed prefix code");
  }
  if (open != 0) fail("VP8L: an incomplete prefix code");
  int c = 0, index = 0;
  for (int len = 1; len <= 15; ++len) {
    code.count[len] = count[len];
    code.first_code[len] = c;
    code.first_index[len] = index;
    c = (c + count[len]) << 1;
    index += count[len];
  }
  code.table_symbol.assign(1 << kPrimaryBits, 0);
  code.table_len.assign(1 << kPrimaryBits, 0);
  for (int len = 1; len <= kPrimaryBits; ++len) {
    for (int i = 0; i < count[len]; ++i) {
      const int cw = code.first_code[len] + i;
      int rev = 0;  // the code's bits in stream order
      for (int b = 0; b < len; ++b) rev |= ((cw >> (len - 1 - b)) & 1) << b;
      for (int fill_ = rev; fill_ < (1 << kPrimaryBits); fill_ += 1 << len) {
        code.table_symbol[fill_] = code.sorted[code.first_index[len] + i];
        code.table_len[fill_] = (uint8_t)len;
      }
    }
  }
}

void read_code_lengths(BitReader& br, const int* cl_lengths, int num_symbols,
                       std::vector<int>& lengths) {
  HuffmanCode cl_code;
  build_code(std::vector<int>(cl_lengths, cl_lengths + 19), cl_code);
  int max_symbol;
  if (br.read(1)) {
    const int length_nbits = 2 + 2 * (int)br.read(3);
    max_symbol = 2 + (int)br.read(length_nbits);
    if (max_symbol > num_symbols) fail("VP8L: too many code lengths");
  } else {
    max_symbol = num_symbols;
  }
  int symbol = 0;
  int prev_len = 8;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    if (br.eos()) fail("VP8L: truncated code lengths");
    const int code_len = cl_code.read(br);
    if (code_len < 16) {
      lengths[symbol++] = code_len;
      if (code_len != 0) prev_len = code_len;
    } else {
      const int slot = code_len - 16;
      const int extra_bits[3] = {2, 3, 7};
      const int repeat_offsets[3] = {3, 3, 11};
      int repeat = (int)br.read(extra_bits[slot]) + repeat_offsets[slot];
      if (symbol + repeat > num_symbols) fail("VP8L: a code-length run past the alphabet");
      const int len = code_len == 16 ? prev_len : 0;
      while (repeat-- > 0) lengths[symbol++] = len;
    }
  }
}

void read_huffman_code(BitReader& br, int alphabet_size, HuffmanCode& code) {
  std::vector<int> lengths(alphabet_size, 0);
  if (br.read(1)) {  // simple code
    const int num_symbols = (int)br.read(1) + 1;
    const int first_len_code = (int)br.read(1);
    int symbol = (int)br.read(first_len_code == 0 ? 1 : 8);
    if (symbol < alphabet_size) lengths[symbol] = 1;
    if (num_symbols == 2) {
      symbol = (int)br.read(8);
      if (symbol < alphabet_size) lengths[symbol] = 1;
    }
  } else {
    int cl_lengths[19] = {0};
    const int num_codes = (int)br.read(4) + 4;
    for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = (int)br.read(3);
    read_code_lengths(br, cl_lengths, alphabet_size, lengths);
  }
  if (br.eos()) fail("VP8L: truncated prefix codes");
  build_code(lengths, code);
}

enum { GREEN = 0, RED, BLUE, ALPHA, DIST };

struct HTreeGroup {
  HuffmanCode codes[5];
};

struct ColorCache {
  std::vector<uint32_t> colors;
  int shift = 0;
  void init(int bits) { colors.assign(1u << bits, 0); shift = 32 - bits; }
  void insert(uint32_t argb) { colors[(argb * 0x1e35a7bdu) >> shift] = argb; }
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Vp8lDecoder {
  BitReader br;
  Transform transforms[4];
  int num_transforms = 0;
  unsigned transforms_seen = 0;

  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0, int* out_xsize);
  void decode_data(std::vector<uint32_t>& data, int width, int height, int cache_bits,
                   const std::vector<HTreeGroup>& groups,
                   const std::vector<uint32_t>& meta, int meta_bits, int meta_xsize);
  void read_transform(int* xsize, int ysize);
};

int copy_length_or_distance(int symbol, BitReader& br) {
  if (symbol < 4) return symbol + 1;
  const int extra_bits = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra_bits;
  return offset + (int)br.read(extra_bits) + 1;
}

int plane_code_to_distance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int dist_code = kCodeToPlane[plane_code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}

void Vp8lDecoder::decode_data(std::vector<uint32_t>& data, int width, int height,
                              int cache_bits, const std::vector<HTreeGroup>& groups,
                              const std::vector<uint32_t>& meta, int meta_bits,
                              int meta_xsize) {
  const size_t total = (size_t)width * height;
  data.assign(total, 0);
  ColorCache cache;
  if (cache_bits > 0) cache.init(cache_bits);
  const int cache_limit = 256 + 24 + (cache_bits > 0 ? (1 << cache_bits) : 0);
  size_t pos = 0, cached = 0;
  int col = 0, row = 0;
  while (pos < total) {
    const HTreeGroup& g =
        meta_bits ? groups[meta[(size_t)(row >> meta_bits) * meta_xsize + (col >> meta_bits)]]
                  : groups[0];
    if (br.eos()) fail("VP8L: the image data are truncated");
    const int code = g.codes[GREEN].read(br);
    if (code < 256) {  // a literal
      const int red = g.codes[RED].read(br);
      const int blue = g.codes[BLUE].read(br);
      const int alpha = g.codes[ALPHA].read(br);
      data[pos++] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) | ((uint32_t)code << 8) | blue;
      if (++col >= width) { col = 0; ++row; }
    } else if (code < 256 + 24) {  // an LZ77 copy
      const int length = copy_length_or_distance(code - 256, br);
      const int dist_symbol = g.codes[DIST].read(br);
      const int dist = plane_code_to_distance(width, copy_length_or_distance(dist_symbol, br));
      if (br.eos()) fail("VP8L: the image data are truncated");
      if (pos < (size_t)dist || total - pos < (size_t)length)
        fail("VP8L: a backward reference outside the image");
      for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
      col += length;
      while (col >= width) { col -= width; ++row; }
    } else if (code < cache_limit) {  // a colour cache entry
      while (cached < pos) cache.insert(data[cached++]);
      data[pos++] = cache.colors[code - 280];
      if (++col >= width) { col = 0; ++row; }
    } else {
      fail("VP8L: an invalid symbol");
    }
    // a lookup sees every pixel before it, as libwebp's lazy insertion
    // leaves its cache
    if (cache_bits > 0) while (cached < pos) cache.insert(data[cached++]);
  }
  if (br.eos()) fail("VP8L: the image data are truncated");
}

std::vector<uint32_t> Vp8lDecoder::decode_stream(int xsize, int ysize, bool level0,
                                                 int* out_xsize) {
  int transform_xsize = xsize;
  if (level0) {
    while (br.read(1)) read_transform(&transform_xsize, ysize);
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = (int)br.read(4);
    if (cache_bits < 1 || cache_bits > 11) fail("VP8L: invalid colour cache size");
  }
  // the prefix codes, and the entropy image where level 0 has one
  std::vector<uint32_t> meta;
  int meta_bits = 0, meta_xsize = 0, num_groups = 1;
  if (level0 && br.read(1)) {
    meta_bits = (int)br.read(3) + 2;
    meta_xsize = subsample(transform_xsize, meta_bits);
    const int meta_ysize = subsample(ysize, meta_bits);
    meta = decode_stream(meta_xsize, meta_ysize, false, nullptr);
    for (auto& m : meta) {
      m = (m >> 8) & 0xffff;
      if ((int)m >= num_groups) num_groups = (int)m + 1;
    }
  }
  if (br.eos()) fail("VP8L: truncated stream");
  std::vector<HTreeGroup> groups(num_groups);
  const int alphabet[5] = {256 + 24 + (cache_bits > 0 ? (1 << cache_bits) : 0), 256, 256, 256, 40};
  for (int i = 0; i < num_groups; ++i)
    for (int j = 0; j < 5; ++j) read_huffman_code(br, alphabet[j], groups[i].codes[j]);
  std::vector<uint32_t> data;
  decode_data(data, transform_xsize, ysize, cache_bits, groups, meta, meta_bits, meta_xsize);
  if (out_xsize) *out_xsize = transform_xsize;
  return data;
}

void Vp8lDecoder::read_transform(int* xsize, int ysize) {
  const int type = (int)br.read(2);
  if (transforms_seen & (1u << type)) fail("VP8L: a transform used twice");
  transforms_seen |= 1u << type;
  Transform& t = transforms[num_transforms++];
  t.type = type;
  t.xsize = *xsize;
  t.ysize = ysize;
  switch (type) {
    case 0:    // predictor
    case 1: {  // cross-colour
      t.bits = (int)br.read(3) + 2;
      t.data = decode_stream(subsample(t.xsize, t.bits), subsample(t.ysize, t.bits), false, nullptr);
      break;
    }
    case 3: {  // colour indexing
      const int num_colors = (int)br.read(8) + 1;
      const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, bits);
      t.bits = bits;
      std::vector<uint32_t> palette = decode_stream(num_colors, 1, false, nullptr);
      const int final_num_colors = 1 << (8 >> bits);
      t.data.assign(final_num_colors, 0);
      uint8_t* nd = reinterpret_cast<uint8_t*>(t.data.data());
      const uint8_t* od = reinterpret_cast<const uint8_t*>(palette.data());
      t.data[0] = palette[0];
      for (int i = 4; i < 4 * num_colors; ++i) nd[i] = (uint8_t)(od[i] + nd[i - 4]);
      break;
    }
    default:  // subtract green
      break;
  }
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

inline int sub3(int a, int b, int c) { return abs(b - c) - abs(a - c); }

inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = sub3((a >> 24), (b >> 24), (c >> 24)) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}

inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t a = clip255((c0 >> 24) + (c1 >> 24) - (c2 >> 24));
  const uint32_t r = clip255(((c0 >> 16) & 0xff) + ((c1 >> 16) & 0xff) - ((c2 >> 16) & 0xff));
  const uint32_t g = clip255(((c0 >> 8) & 0xff) + ((c1 >> 8) & 0xff) - ((c2 >> 8) & 0xff));
  const uint32_t b = clip255((c0 & 0xff) + (c1 & 0xff) - (c2 & 0xff));
  return (a << 24) | (r << 16) | (g << 8) | b;
}

inline int add_subtract_half(int a, int b) { return (int)clip255((uint32_t)(a + (a - b) / 2)); }

inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  const int a = add_subtract_half(ave >> 24, c2 >> 24);
  const int r = add_subtract_half((ave >> 16) & 0xff, (c2 >> 16) & 0xff);
  const int g = add_subtract_half((ave >> 8) & 0xff, (c2 >> 8) & 0xff);
  const int b = add_subtract_half(ave & 0xff, c2 & 0xff);
  return ((uint32_t)a << 24) | ((uint32_t)r << 16) | ((uint32_t)g << 8) | (uint32_t)b;
}

// predictor `mode` for the pixel at `out` (left out[-1], top row `top`)
inline uint32_t predict(int mode, const uint32_t* out, const uint32_t* top) {
  const uint32_t L = out[-1];
  switch (mode) {
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(L, top[1]), top[0]);
    case 6: return average2(L, top[-1]);
    case 7: return average2(L, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], L, top[-1]);
    case 12: return clamped_add_subtract_full(L, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(L, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
  }
}

// one inverse transform over the whole image, in place: `pix` holds
// t.ysize rows of the transform's input width and leaves with t.xsize
void inverse_transform(const Transform& t, std::vector<uint32_t>& pix) {
  const int width = t.xsize, height = t.ysize;
  switch (t.type) {
    case 2:  // subtract green
      for (auto& p : pix) {
        const uint32_t green = (p >> 8) & 0xff;
        uint32_t rb = p & 0x00ff00ffu;
        rb += (green << 16) | green;
        p = (p & 0xff00ff00u) | (rb & 0x00ff00ffu);
      }
      break;
    case 0: {  // predictor: the contiguous buffer makes the top-right of a
               // row's last pixel the row's first, as in libwebp
      uint32_t* out = pix.data();
      out[0] = add_pixels(out[0], 0xff000000u);
      for (int x = 1; x < width; ++x) out[x] = add_pixels(out[x], out[x - 1]);
      const int tiles_per_row = subsample(width, t.bits);
      for (int y = 1; y < height; ++y) {
        uint32_t* row = out + (size_t)y * width;
        const uint32_t* top = row - width;
        const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) * tiles_per_row;
        row[0] = add_pixels(row[0], top[0]);
        for (int x = 1; x < width; ++x) {
          const int mode = (modes[x >> t.bits] >> 8) & 0xf;
          row[x] = add_pixels(row[x], predict(mode, row + x, top + x));
        }
      }
      break;
    }
    case 1: {  // cross-colour
      const int tiles_per_row = subsample(width, t.bits);
      for (int y = 0; y < height; ++y) {
        uint32_t* row = pix.data() + (size_t)y * width;
        const uint32_t* codes = t.data.data() + (size_t)(y >> t.bits) * tiles_per_row;
        for (int x = 0; x < width; ++x) {
          const uint32_t code = codes[x >> t.bits];
          const int8_t g2r = (int8_t)(code & 0xff);
          const int8_t g2b = (int8_t)((code >> 8) & 0xff);
          const int8_t r2b = (int8_t)((code >> 16) & 0xff);
          const uint32_t argb = row[x];
          const int8_t green = (int8_t)(argb >> 8);
          int new_red = (argb >> 16) & 0xff;
          int new_blue = argb & 0xff;
          new_red += ((int)g2r * green) >> 5;
          new_red &= 0xff;
          new_blue += ((int)g2b * green) >> 5;
          new_blue += ((int)r2b * (int8_t)new_red) >> 5;
          new_blue &= 0xff;
          row[x] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) | (uint32_t)new_blue;
        }
      }
      break;
    }
    case 3: {  // colour indexing, pixels unbundled
      const int packed_width = subsample(width, t.bits);
      std::vector<uint32_t> out((size_t)width * height);
      const int bits_per_pixel = 8 >> t.bits;
      const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
      const int count_mask = (1 << t.bits) - 1;
      for (int y = 0; y < height; ++y) {
        const uint32_t* src = pix.data() + (size_t)y * packed_width;
        uint32_t* dst = out.data() + (size_t)y * width;
        uint32_t packed = 0;
        for (int x = 0; x < width; ++x) {
          if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
          dst[x] = t.data[packed & bit_mask];
          packed >>= bits_per_pixel;
        }
      }
      pix.swap(out);
      break;
    }
  }
}

void vp8l_header(const uint8_t* data, size_t size, int* w, int* h) {
  if (size < 5 || data[0] != 0x2f) fail("VP8L: no lossless signature");
  if ((data[4] >> 5) != 0) fail("VP8L: an unknown version");
  BitReader br;
  br.init(data, size);
  br.read(8);
  *w = (int)br.read(14) + 1;
  *h = (int)br.read(14) + 1;
  br.read(1);  // alpha hint
  br.read(3);  // version
}

// ARGB pixels of a VP8L image of `xsize` x `ysize`; `headerless` for the
// ALPH chunk's stream, which carries no signature and no size
std::vector<uint32_t> decode_vp8l(const uint8_t* data, size_t size, int xsize, int ysize,
                                  bool headerless) {
  Vp8lDecoder d;
  d.br.init(data, size);
  if (!headerless) {
    d.br.read(8 + 14 + 14 + 1 + 3);
    if (d.br.eos()) fail("VP8L: truncated header");
  }
  std::vector<uint32_t> pix = d.decode_stream(xsize, ysize, true, nullptr);
  for (int i = d.num_transforms - 1; i >= 0; --i) inverse_transform(d.transforms[i], pix);
  return pix;
}

// ----------------------------------------------------------------- ALPH

void decode_alpha(const uint8_t* data, size_t size, int width, int height, uint8_t* alpha) {
  if (size <= 1) fail("ALPH: an empty alpha chunk");
  const int method = data[0] & 3;
  const int filter = (data[0] >> 2) & 3;
  const int pre_processing = (data[0] >> 4) & 3;
  const int rsrv = (data[0] >> 6) & 3;
  if (method > 1 || pre_processing > 1 || rsrv != 0) fail("ALPH: an invalid alpha header");
  const size_t n = (size_t)width * height;
  std::vector<uint8_t> deltas(n);
  if (method == 0) {
    if (size - 1 < n) fail("ALPH: the raw alpha plane is truncated");
    memcpy(deltas.data(), data + 1, n);
  } else {
    std::vector<uint32_t> argb = decode_vp8l(data + 1, size - 1, width, height, true);
    for (size_t i = 0; i < n; ++i) deltas[i] = (uint8_t)(argb[i] >> 8);
  }
  // undo the filter, each row from the previous output row
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = deltas.data() + (size_t)y * width;
    uint8_t* out = alpha + (size_t)y * width;
    const uint8_t* prev = y > 0 ? out - width : nullptr;
    if (filter == 0) {
      memcpy(out, in, width);
    } else if (filter == 1 || prev == nullptr) {  // horizontal
      uint8_t pred = prev == nullptr ? 0 : prev[0];
      for (int i = 0; i < width; ++i) { out[i] = (uint8_t)(pred + in[i]); pred = out[i]; }
    } else if (filter == 2) {  // vertical
      for (int i = 0; i < width; ++i) out[i] = (uint8_t)(prev[i] + in[i]);
    } else {  // gradient
      uint8_t top = prev[0], top_left = top, left = top;
      for (int i = 0; i < width; ++i) {
        top = prev[i];
        const int g = left + top - top_left;
        const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
        left = (uint8_t)(in[i] + pred);
        top_left = top;
        out[i] = left;
      }
    }
  }
}

// ------------------------------------------------------------- container

struct Image {
  int width = 0, height = 0, channels = 4;
  std::vector<uint8_t> pixels;
};

// one still image: [ALPH] VP8 | VP8L (or a raw bitstream), from `data` to
// the end of the given bytes; `alph` may be null. `expect_w/h` the canvas
// of a VP8X header or 0.
void decode_still(const uint8_t* data, size_t size, bool lossless, size_t chunk_size,
                  const uint8_t* alph, size_t alph_size, int expect_w, int expect_h,
                  Image& img) {
  int w, h;
  if (!lossless) {
    vp8_frame_size(data, size, chunk_size, &w, &h);
  } else {
    vp8l_header(data, size, &w, &h);
  }
  if (expect_w && (w != expect_w || h != expect_h))
    fail("the VP8X canvas and the frame differ in size");
  img.width = w;
  img.height = h;
  img.channels = 4;
  img.pixels.assign((size_t)w * h * 4, 0);
  if (lossless) {
    std::vector<uint32_t> argb = decode_vp8l(data, size, w, h, false);
    uint8_t* o = img.pixels.data();
    for (size_t i = 0; i < argb.size(); ++i, o += 4) {
      const uint32_t p = argb[i];
      o[0] = (uint8_t)(p >> 16);
      o[1] = (uint8_t)(p >> 8);
      o[2] = (uint8_t)p;
      o[3] = (uint8_t)(p >> 24);
    }
    return;
  }
  Vp8Frame f;
  decode_vp8(data, size, f);
  frame_to_rgba(f, img.pixels.data());
  if (alph != nullptr) {
    std::vector<uint8_t> alpha((size_t)w * h);
    decode_alpha(alph, alph_size, w, h, alpha.data());
    for (size_t i = 0; i < alpha.size(); ++i) img.pixels[4 * i + 3] = alpha[i];
  }
}

constexpr uint32_t kMaxChunkPayload = ~0u - 8 - 1;
constexpr uint32_t kAnimationFlag = 0x02, kAlphaFlag = 0x10;

bool tag_is(const uint8_t* p, const char* tag) { return memcmp(p, tag, 4) == 0; }

// the optional chunks before the image chunk (libwebp's
// ParseOptionalChunks): returns the position of "VP8 " / "VP8L" and the
// ALPH chunk, if one comes first
const uint8_t* skip_optional_chunks(const uint8_t* p, const uint8_t* end, size_t riff_size,
                                    const uint8_t** alph, size_t* alph_size) {
  uint32_t total_size = 4 + 8 + 10;  // "WEBP" + the VP8X chunk
  while (true) {
    if ((size_t)(end - p) < 8) fail("truncated chunk header");
    const uint32_t chunk_size = le32(p + 4);
    if (chunk_size > kMaxChunkPayload) fail("an invalid chunk size");
    const uint32_t disk_chunk_size = (8 + chunk_size + 1) & ~1u;
    total_size += disk_chunk_size;
    if (riff_size > 0 && total_size > riff_size) fail("a chunk runs past the RIFF size");
    if (tag_is(p, "VP8 ") || tag_is(p, "VP8L")) return p;
    if ((size_t)(end - p) < disk_chunk_size) fail("a chunk is truncated");
    if (tag_is(p, "ALPH")) {
      *alph = p + 8;
      *alph_size = chunk_size;
    }
    p += disk_chunk_size;
  }
}

// "VP8 " / "VP8L" chunk header (ParseVP8Header); returns the payload
const uint8_t* image_chunk(const uint8_t* p, const uint8_t* end, size_t riff_size,
                           bool* lossless, size_t* chunk_size) {
  if ((size_t)(end - p) < 8) fail("truncated image chunk header");
  const bool is_vp8 = tag_is(p, "VP8 ");
  const bool is_vp8l = tag_is(p, "VP8L");
  if (is_vp8 || is_vp8l) {
    const uint32_t size = le32(p + 4);
    if (riff_size >= 12 && size > riff_size - 12) fail("inconsistent chunk size");
    if (size > (size_t)(end - p) - 8) fail("the image chunk is truncated");
    *lossless = is_vp8l;
    *chunk_size = size;
    return p + 8;
  }
  // a raw bitstream without a chunk header
  *lossless = (end - p) >= 5 && p[0] == 0x2f && (p[4] >> 5) == 0;
  *chunk_size = (size_t)(end - p);
  return p;
}

void decode_webp(const uint8_t* data, size_t size, Image& img) {
  const uint8_t* p = data;
  const uint8_t* end = data + size;
  size_t riff_size = 0;
  bool found_riff = false;
  if (size >= 12 && tag_is(p, "RIFF")) {
    if (!tag_is(p + 8, "WEBP")) fail("not a WebP stream (no WEBP signature)");
    const uint32_t rs = le32(p + 4);
    if (rs < 12) fail("a RIFF size too small");
    if (rs > kMaxChunkPayload) fail("a RIFF size too large");
    if (rs > size - 8) fail("the RIFF stream is truncated");
    riff_size = rs;
    found_riff = true;
    p += 12;
  }
  if ((size_t)(end - p) < 8) fail("a truncated stream");
  if (tag_is(p, "VP8X")) {
    if (!found_riff) fail("a VP8X chunk outside a RIFF container");
    if (le32(p + 4) != 10) fail("a VP8X chunk of the wrong size");
    if ((size_t)(end - p) < 18) fail("the VP8X chunk is truncated");
    const uint32_t flags = le32(p + 8);
    const int canvas_w = 1 + (int)le24(p + 12);
    const int canvas_h = 1 + (int)le24(p + 15);
    if ((uint64_t)canvas_w * canvas_h >= (1ull << 32)) fail("an image too large");
    p += 18;
    if (flags & kAnimationFlag) {
      // the first ANMF frame on a transparent black canvas, as Pillow's
      // WebPAnimDecoder leaves it; RGB where the header has no alpha flag
      while (true) {
        if ((size_t)(end - p) < 8) fail("an animation without a frame");
        const uint32_t chunk_size = le32(p + 4);
        const uint32_t disk = (8 + chunk_size + 1) & ~1u;
        if (chunk_size > (size_t)(end - p) - 8) fail("a truncated animation chunk");
        if (tag_is(p, "ANMF")) {
          if (chunk_size < 16) fail("an ANMF chunk too small");
          const uint8_t* fr = p + 8;
          const int x_off = 2 * (int)le24(fr);
          const int y_off = 2 * (int)le24(fr + 3);
          const int fw = 1 + (int)le24(fr + 6);
          const int fh = 1 + (int)le24(fr + 9);
          if (x_off + fw > canvas_w || y_off + fh > canvas_h)
            fail("an animation frame outside its canvas");
          const uint8_t* q = fr + 16;
          const uint8_t* fend = fr + chunk_size;
          const uint8_t* alph = nullptr;
          size_t alph_size = 0;
          while (true) {  // ALPH, unknown chunks, then VP8 / VP8L
            if ((size_t)(fend - q) < 8) fail("an animation frame without an image");
            const uint32_t cs = le32(q + 4);
            if (tag_is(q, "VP8 ") || tag_is(q, "VP8L")) break;
            if (cs > (size_t)(fend - q) - 8) fail("a truncated frame chunk");
            if (tag_is(q, "ALPH")) { alph = q + 8; alph_size = cs; }
            q += (8 + cs + 1) & ~1u;
          }
          bool lossless;
          size_t image_size;
          const uint8_t* payload = image_chunk(q, fend, 0, &lossless, &image_size);
          Image frame;
          decode_still(payload, (size_t)(fend - payload), lossless, image_size,
                       lossless ? nullptr : alph, alph_size, fw, fh, frame);
          const int channels = (flags & kAlphaFlag) ? 4 : 3;
          img.width = canvas_w;
          img.height = canvas_h;
          img.channels = channels;
          img.pixels.assign((size_t)canvas_w * canvas_h * channels, 0);
          for (int y = 0; y < fh; ++y)
            for (int x = 0; x < fw; ++x) {
              const uint8_t* s = frame.pixels.data() + ((size_t)y * fw + x) * 4;
              uint8_t* o = img.pixels.data() +
                           ((size_t)(y + y_off) * canvas_w + x + x_off) * channels;
              memcpy(o, s, channels);
            }
          return;
        }
        p += disk;
      }
    }
    const uint8_t* alph = nullptr;
    size_t alph_size = 0;
    p = skip_optional_chunks(p, end, riff_size, &alph, &alph_size);
    bool lossless;
    size_t chunk_size;
    const uint8_t* payload = image_chunk(p, end, riff_size, &lossless, &chunk_size);
    decode_still(payload, (size_t)(end - payload), lossless, chunk_size,
                 lossless ? nullptr : alph, alph_size, canvas_w, canvas_h, img);
    return;
  }
  bool lossless;
  size_t chunk_size;
  const uint8_t* payload = image_chunk(p, end, riff_size, &lossless, &chunk_size);
  decode_still(payload, (size_t)(end - payload), lossless, chunk_size, nullptr, 0, 0, 0, img);
}

}  // namespace

extern "C" {

int vt_decode_webp(const uint8_t* data, size_t len, uint8_t** pixels, int* height,
                   int* width, int* channels, char* err, int errlen) {
  *pixels = nullptr;
  try {
    Image img;
    decode_webp(data, len, img);
    uint8_t* out = static_cast<uint8_t*>(malloc(img.pixels.size()));
    if (out == nullptr) return -2;
    memcpy(out, img.pixels.data(), img.pixels.size());
    *pixels = out;
    *height = img.height;
    *width = img.width;
    *channels = img.channels;
    return 0;
  } catch (const DecodeError& e) {
    if (err != nullptr && errlen > 0) snprintf(err, errlen, "%s", e.what);
    return -1;
  } catch (const std::bad_alloc&) {
    return -2;
  }
}

void vt_webp_free(void* p) { free(p); }

}  // extern "C"
