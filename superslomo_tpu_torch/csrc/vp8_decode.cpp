// The lossy WebP (VP8 key frame) decode that cv2.imread runs through libwebp,
// from the bitstream to RGB pixels, computed as libwebp's vp8_dec.c,
// tree_dec.c, quant_dec.c, frame_dec.c, dsp/dec.c, dsp/upsampling.c and
// dsp/yuv.h compute it:
//   the frame tag (key frame, version 0-3, shown, the first partition's size)
//   and the key-frame header (start code, 14-bit sizes; the scale bits read
//   and ignored);
//   the boolean decoder, which fails where a bit needs a byte past its
//   partition (libwebp's reader marks its end there and the decode fails at
//   the partition's next check), and an empty partition where it is checked;
//   the first partition's header: colour space and clamping bits (ignored),
//   segmentation (absolute or delta quantisers and filter levels, the tree
//   probabilities, 255 by default), the filter type bit, level and sharpness,
//   the loop-filter deltas (a key frame reads reference delta 0, and mode
//   delta 0 for B_PRED), 1, 2, 4 or 8 token partitions (3-byte sizes clamped
//   to what is left; the last takes the rest and must not be empty), the
//   quantiser indices with libwebp's clamps (Y2 DC x 2, Y2 AC x 155 / 100 at
//   least 8, UV DC at most 132), the token probability updates, the skip
//   probability;
//   per macroblock: the segment, the skip flag, the 16x16 mode or B_PRED's
//   sixteen sub-modes in the context of those above and to the left (a 16x16
//   mode stands for its sub-mode), the chroma mode; the tokens from partition
//   mb_y % count: the four block types, the bands, three contexts, no end of
//   block after a zero, DCT_CAT1-6's extra bits, the zigzag, an int16 store
//   of each dequantised coefficient; a skipped macroblock clears the non-zero
//   contexts, the Y2 context only when it is not B_PRED;
//   the inverse WHT of Y2 and libwebp's inverse DCT (20091, 35468);
//   intra prediction from the reconstruction before the loop filter: 127
//   above the top row, 129 left of the left column, the corner of each case,
//   DC without its top or left edge (or both: 128), TM clamped, the ten 4x4
//   modes whose top-right pixels come from the next macroblock's row above
//   (at the right edge its pixel 15, on the top row 127, for sub-block rows
//   1-3 the macroblock's own top-right);
//   the loop filter: a level per segment and B_PRED, with the deltas, clamped
//   to 0..63 (0: none), the interior limit from the sharpness, the key frame's
//   hev thresholds, the simple filter on luma or the normal one on luma and
//   chroma, the left edge, the inner vertical edges (skipped for a macroblock
//   without coefficients that is not B_PRED), the top edge, the inner
//   horizontal edges, the frame's own borders left alone;
//   the output cropped to the frame, libwebp's fancy upsampling of the 4:2:0
//   chroma and its fixed-point YUV to RGB.
//
// Host code: data/webp.py calls vp8_decode through ctypes, which releases the
// interpreter lock, so the Loader's threads decode frames in parallel;
// data/vp8.py is its plain Python twin. ops/cuda_build.py compiles this file
// with the host C++ compiler at first use.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum Error : int64_t {
  kBadCode = -1,    // a frame that libwebp refuses
  kTruncated = -2,  // a bit past a partition's end, or an empty partition
};

struct Fail {
  int64_t code;
};

// the default token probabilities [type][band][context][node], their update
// probabilities, and the key-frame 4x4 mode probabilities [above][left][node]
constexpr uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128, 1,
    98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128, 78, 134,
    202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128, 184, 150, 247,
    255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128, 1, 101, 251, 255,
    241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128, 37, 116, 196, 243,
    228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128, 207, 160, 250, 255, 238,
    128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128, 1, 152, 252, 255, 240, 255,
    128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128, 80, 129, 211, 255, 194, 224,
    128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 246, 1, 255, 128, 128, 128, 128,
    128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 198, 35, 237, 223, 193, 187, 162,
    160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1, 68, 47, 146, 208, 149, 167, 221, 162,
    255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128, 184, 141, 234, 253, 222, 220, 255, 199, 128,
    128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128, 1, 129, 232, 253, 214, 197, 242, 196, 255, 255,
    128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128, 23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128, 109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44,
    130, 201, 253, 205, 192, 255, 255, 128, 128, 128, 1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136,
    225, 251, 218, 190, 255, 255, 128, 128, 128, 22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249,
    255, 232, 235, 128, 128, 128, 128, 128, 124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251,
    193, 211, 255, 205, 128, 128, 128, 1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225,
    227, 255, 255, 128, 128, 128, 45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255,
    128, 128, 128, 128, 128, 203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128,
    128, 128, 128, 128, 253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198,
    255, 255, 128, 73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128,
    128, 128, 239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128,
    128, 1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128, 223,
    165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128, 1, 16,
    248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128, 149, 1, 255,
    128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128, 247, 192, 255, 128,
    128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 134, 252, 255, 255,
    128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128, 55, 93, 255, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 202, 24, 213, 235, 186, 191,
    220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128, 61, 46, 138, 219, 151, 178, 240,
    170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128, 166, 109, 228, 252, 211, 215, 255, 174,
    128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128, 1, 52, 220, 246, 198, 199, 249, 220, 255,
    255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128, 24, 71, 130, 219, 154, 170, 243, 182, 255, 255,
    128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128, 149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128, 1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123,
    102, 209, 247, 188, 196, 255, 233, 128, 128, 128, 20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222,
    248, 255, 216, 213, 128, 128, 128, 128, 128, 168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116,
    215, 255, 211, 212, 255, 255, 128, 128, 128, 1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213,
    252, 201, 202, 255, 219, 128, 128, 128, 42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128,
    128, 128, 128, 128, 128, 128, 128, 244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128,
    128, 128, 128, 128, 128, 128};
constexpr uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255};
constexpr uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95, 175, 69, 143, 80, 85, 82,
    72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152, 114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195,
    26, 62, 44, 64, 85, 144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71, 63, 20, 8,
    114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36, 134, 183, 89, 137, 98, 101, 106, 165, 148, 72,
    187, 100, 130, 157, 111, 32, 75, 80, 66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8,
    107, 74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128, 104, 79, 12, 27, 217, 255,
    87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23, 47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197,
    189, 23, 18, 22, 88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61, 39, 53, 200, 87,
    26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77, 39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116,
    206, 23, 34, 43, 166, 73, 107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114, 34, 19,
    21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51, 193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111, 112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10,
    25, 109, 88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209, 100, 80, 8, 43, 154, 1,
    51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171, 41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209,
    192, 23, 25, 82, 138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179, 63, 59, 90, 180,
    59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175, 47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33,
    183, 6, 98, 15, 32, 183, 57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205, 40, 3, 9,
    115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47, 104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70,
    205, 40, 41, 23, 26, 57, 54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134, 39, 19,
    53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73, 75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31,
    35, 67, 102, 85, 55, 186, 85, 56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98, 125,
    98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45, 75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49, 38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26, 57, 18, 10, 102, 102, 213, 34, 20,
    43, 117, 20, 15, 36, 163, 128, 68, 1, 26, 102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28,
    222, 37, 68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70, 37, 43, 37, 154, 100, 163,
    85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85, 75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25,
    248, 1, 56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40, 164, 50, 31, 137, 154,
    133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158, 86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17,
    131, 240, 154, 14, 1, 209, 45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213, 83, 12,
    13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171, 18, 11, 7, 63, 144, 171, 4, 4, 246, 35,
    27, 10, 146, 174, 171, 12, 26, 128, 190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62, 71, 30, 17, 119, 118, 255, 17,
    18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142, 146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1,
    81, 188, 64, 32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24};

constexpr int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,  17,  18,  19,  20,  20,  21,  21,
    22,  22,  23,  23,  24,  25,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,
    40,  41,  42,  43,  44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  59,  60,
    61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,  75,  76,  76,  77,  78,  79,  80,  81,
    82,  83,  84,  85,  86,  87,  88,  89,  91,  93,  95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114,
    116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
constexpr uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,  20,  21,  22,  23,  24,  25,
    26,  27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,
    48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,  70,  72,  74,  76,  78,  80,
    82,  84,  86,  88,  90,  92,  94,  96,  98,  100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128,
    131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201,
    205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's intra modes: a 16x16 or chroma mode is the 4x4 mode of its number
enum Mode { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
constexpr int DC_PRED = B_DC, TM_PRED = B_TM, V_PRED = B_VE, H_PRED = B_HE;

struct Bits {  // libwebp's VP8BitReader, a byte loaded at a time
  const uint8_t* p;
  int64_t pos, end;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;  // the range less 1
  bool empty;
  Bits() : p(nullptr), pos(0), end(0), empty(true) {}
  Bits(const uint8_t* src, int64_t start, int64_t stop) : p(src), pos(start), end(stop), empty(start >= stop) {
    if (empty) {
      bits = 0;
    } else {
      load();
    }
  }
  void load() {
    if (pos >= end) throw Fail{kTruncated};
    value = (value << 8) | p[pos++];
    bits += 8;
  }
  int bit(int prob) {
    if (bits < 0) load();
    uint32_t rng = range;
    const uint32_t split = (rng * static_cast<uint32_t>(prob)) >> 8;
    int b;
    if (static_cast<uint32_t>(value >> bits) > split) {
      rng -= split;
      value -= static_cast<uint64_t>(split + 1) << bits;
      b = 1;
    } else {
      rng = split + 1;
      b = 0;
    }
    const int shift = __builtin_clz(rng) - 24;  // 8 - bit length
    range = (rng << shift) - 1;
    bits -= shift;
    return b;
  }
  int literal(int n) {
    int v = 0;
    while (n-- > 0) v = (v << 1) | bit(128);
    return v;
  }
  int signed_value(int n) {
    const int v = literal(n);
    return bit(128) ? -v : v;
  }
  void check() const {
    if (empty) throw Fail{kTruncated};
  }
};

inline int16_t wrap16(int64_t v) { return static_cast<int16_t>(static_cast<uint16_t>(v & 0xffff)); }
inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
inline uint8_t clip8(int64_t v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

typedef uint8_t Probas[3][11];

struct Frame {
  // header
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  int use_segment = 0, update_map = 0, absolute = 1;
  int quant[4] = {0, 0, 0, 0}, strength[4] = {0, 0, 0, 0};
  int seg_probs[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_delta[4] = {0, 0, 0, 0}, mode_delta[4] = {0, 0, 0, 0};
  int dq[4][3][2];  // segment → (Y1, Y2, UV) → (DC, AC)
  Probas proba[4][8];
  const Probas* bands[4][17];
  int use_skip = 0, skip_p = 0;
  Bits br;
  std::vector<Bits> parts;
  // per macroblock
  std::vector<uint8_t> segment, i4x4, inner, uv_mode, modes;  // modes: 16 a macroblock
  std::vector<int16_t> coeffs;                                 // 384 a macroblock
  // planes: the reconstruction, then the loop filter, in place
  std::vector<uint8_t> Y, U, V;
  int ys = 0, uvs = 0;  // strides
};

int large_value(Bits& br, const uint8_t* p) {  // GetLargeValue
  if (!br.bit(p[3])) return !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
  if (!br.bit(p[6])) {
    if (!br.bit(p[7])) return 5 + br.bit(159);
    const int v = 7 + 2 * br.bit(165);
    return v + br.bit(145);
  }
  const int bit1 = br.bit(p[8]);
  const int cat = 2 * bit1 + br.bit(p[9 + bit1]);
  int v = 0;
  for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v = 2 * v + br.bit(*tab);
  return v + 3 + (8 << cat);
}

// GetCoeffs: one block's tokens from index n, dequantised into out (raster
// order); returns the index after the last token read.
int get_coeffs(Bits& br, const Probas* const* bands, int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = (*bands[n])[ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = (*bands[++n])[0];
      if (n == 16) return 16;
    }
    const Probas* next = bands[n + 1];
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = (*next)[1];
    } else {
      v = large_value(br, p);
      p = (*next)[2];
    }
    if (br.bit(128)) v = -v;
    out[kZigzag[n]] = wrap16(static_cast<int64_t>(v) * dq[n > 0]);
  }
  return 16;
}

inline int64_t mul1(int64_t a) { return ((a * 20091) >> 16) + a; }
inline int64_t mul2(int64_t a) { return (a * 35468) >> 16; }

// TransformOne: the 4x4 residual of 16 coefficients (raster order) added to
// dst (stride bps) with the clamp.
void inverse_dct_add(const int16_t* in, uint8_t* dst, int bps) {
  int64_t t[16];
  for (int i = 0; i < 4; ++i) {  // the vertical pass, column i
    const int64_t a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    const int64_t c = mul2(in[4 + i]) - mul1(in[12 + i]), d = mul1(in[4 + i]) + mul2(in[12 + i]);
    t[0 + i] = a + d;
    t[4 + i] = b + c;
    t[8 + i] = b - c;
    t[12 + i] = a - d;
  }
  for (int i = 0; i < 4; ++i) {  // the horizontal pass, row i
    const int64_t* r = t + 4 * i;
    const int64_t dc = r[0] + 4;
    const int64_t a = dc + r[2], b = dc - r[2];
    const int64_t c = mul2(r[1]) - mul1(r[3]), d = mul1(r[1]) + mul2(r[3]);
    uint8_t* o = dst + i * bps;
    o[0] = clip8(o[0] + ((a + d) >> 3));
    o[1] = clip8(o[1] + ((b + c) >> 3));
    o[2] = clip8(o[2] + ((b - c) >> 3));
    o[3] = clip8(o[3] + ((a - d) >> 3));
  }
}

// TransformWHT: the Y2 block (raster order) → the DC of each luma block.
void inverse_wht(const int16_t* in, int16_t* coeffs) {
  int64_t t[16];
  for (int i = 0; i < 4; ++i) {
    const int64_t a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int64_t a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    t[0 + i] = a0 + a1;
    t[8 + i] = a0 - a1;
    t[4 + i] = a3 + a2;
    t[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int64_t dc = t[4 * i] + 3;
    const int64_t a0 = dc + t[4 * i + 3], a1 = t[4 * i + 1] + t[4 * i + 2];
    const int64_t a2 = t[4 * i + 1] - t[4 * i + 2], a3 = dc - t[4 * i + 3];
    coeffs[16 * (4 * i + 0)] = wrap16((a0 + a1) >> 3);
    coeffs[16 * (4 * i + 1)] = wrap16((a3 + a2) >> 3);
    coeffs[16 * (4 * i + 2)] = wrap16((a0 - a1) >> 3);
    coeffs[16 * (4 * i + 3)] = wrap16((a3 - a2) >> 3);
  }
}

void parse_header(Frame& f, const uint8_t* data, int64_t n) {
  Bits& br = f.br;
  br.literal(2);  // colour space and clamping type: ignored
  f.use_segment = br.bit(128);
  if (f.use_segment) {
    f.update_map = br.bit(128);
    if (br.bit(128)) {
      f.absolute = br.bit(128);
      for (int& q : f.quant) q = br.bit(128) ? br.signed_value(7) : 0;
      for (int& s : f.strength) s = br.bit(128) ? br.signed_value(6) : 0;
    }
    if (f.update_map)
      for (int& p : f.seg_probs) p = br.bit(128) ? br.literal(8) : 255;
  }
  br.check();
  f.simple = br.bit(128);
  f.level = br.literal(6);
  f.sharpness = br.literal(3);
  f.use_lf_delta = br.bit(128);
  if (f.use_lf_delta && br.bit(128)) {
    for (int& d : f.ref_delta)
      if (br.bit(128)) d = br.signed_value(6);
    for (int& d : f.mode_delta)
      if (br.bit(128)) d = br.signed_value(6);
  }
  // the token partitions
  const int last = (1 << br.literal(2)) - 1;
  const int64_t start = br.end;
  if (n - start < 3 * last) throw Fail{kTruncated};
  int64_t at = start + 3 * last, left = n - at;
  for (int p = 0; p < last; ++p) {
    const uint8_t* sz = data + start + 3 * p;
    const int64_t size = std::min<int64_t>(sz[0] | sz[1] << 8 | sz[2] << 16, left);
    f.parts.emplace_back(data, at, at + size);
    at += size;
    left -= size;
  }
  if (at >= n) throw Fail{kTruncated};
  f.parts.emplace_back(data, at, n);
  // the quantisers
  const int base = br.literal(7);
  int dq[5];
  for (int& d : dq) d = br.bit(128) ? br.signed_value(4) : 0;  // Y1 DC, Y2 DC, Y2 AC, UV DC, UV AC
  for (int s = 0; s < 4; ++s) {
    const int q = f.use_segment ? f.quant[s] + (f.absolute ? 0 : base) : base;
    f.dq[s][0][0] = kDcTable[clip(q + dq[0], 127)];
    f.dq[s][0][1] = kAcTable[clip(q, 127)];
    f.dq[s][1][0] = kDcTable[clip(q + dq[1], 127)] * 2;
    f.dq[s][1][1] = std::max((kAcTable[clip(q + dq[2], 127)] * 101581) >> 16, 8);  // x 155 / 100
    f.dq[s][2][0] = kDcTable[clip(q + dq[3], 117)];
    f.dq[s][2][1] = kAcTable[clip(q + dq[4], 127)];
  }
  br.bit(128);  // refresh entropy probabilities: ignored
  for (int t = 0; t < 4; ++t) {
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int k = ((t * 8 + b) * 3 + c) * 11 + p;
          f.proba[t][b][c][p] = static_cast<uint8_t>(br.bit(kCoeffsUpdateProba[k]) ? br.literal(8) : kCoeffsProba0[k]);
        }
    for (int i = 0; i < 17; ++i) f.bands[t][i] = &f.proba[t][kBands[i]];
  }
  f.use_skip = br.bit(128);
  if (f.use_skip) f.skip_p = br.literal(8);
}

// ParseIntraMode for macroblock mb: top (4 sub-modes) and left (4) are the contexts.
int parse_modes(Frame& f, int mb, uint8_t* top, uint8_t* left) {
  Bits& br = f.br;
  f.segment[mb] = 0;
  if (f.update_map)
    f.segment[mb] = br.bit(f.seg_probs[0]) ? 2 + br.bit(f.seg_probs[2]) : br.bit(f.seg_probs[1]);
  const int skip = f.use_skip ? br.bit(f.skip_p) : 0;
  uint8_t* modes = &f.modes[16 * mb];
  f.i4x4[mb] = !br.bit(145);
  if (!f.i4x4[mb]) {
    const int mode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED) : (br.bit(163) ? V_PRED : DC_PRED);
    modes[0] = static_cast<uint8_t>(mode);
    std::memset(top, mode, 4);
    std::memset(left, mode, 4);
  } else {
    for (int y = 0; y < 4; ++y) {
      int mode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* p = kBModesProba + (top[x] * 10 + mode) * 9;
        if (!br.bit(p[0])) mode = B_DC;
        else if (!br.bit(p[1])) mode = B_TM;
        else if (!br.bit(p[2])) mode = B_VE;
        else if (!br.bit(p[3])) mode = !br.bit(p[4]) ? B_HE : (!br.bit(p[5]) ? B_RD : B_VR);
        else if (!br.bit(p[6])) mode = B_LD;
        else if (!br.bit(p[7])) mode = B_VL;
        else mode = !br.bit(p[8]) ? B_HD : B_HU;
        top[x] = static_cast<uint8_t>(mode);
      }
      std::memcpy(modes + 4 * y, top, 4);
      left[y] = static_cast<uint8_t>(mode);
    }
  }
  f.uv_mode[mb] = static_cast<uint8_t>(!br.bit(142) ? DC_PRED : !br.bit(114) ? V_PRED : br.bit(183) ? TM_PRED : H_PRED);
  return skip;
}

// ParseResiduals: the 24 blocks' coefficients; nz / nz_dc are the contexts above
// (index mb_x) and to the left (index mb_w). Returns whether any block has one.
bool parse_residuals(Frame& f, Bits& br, int mb, int mb_x, std::vector<uint32_t>& nz, std::vector<uint8_t>& nz_dc) {
  const int L = f.mb_w;
  const int(*q)[2] = f.dq[f.segment[mb]];
  int16_t* dst = &f.coeffs[384 * static_cast<size_t>(mb)];
  std::memset(dst, 0, 384 * sizeof(int16_t));
  bool non_zero = false;
  int first;
  const Probas* const* ac;
  if (!f.i4x4[mb]) {
    int16_t dc[16] = {0};
    const int n = get_coeffs(br, f.bands[1], nz_dc[mb_x] + nz_dc[L], q[1], 0, dc);
    nz_dc[mb_x] = nz_dc[L] = n > 0;
    inverse_wht(dc, dst);
    first = 1;
    ac = f.bands[0];
  } else {
    first = 0;
    ac = f.bands[3];
  }
  uint32_t tnz = nz[mb_x] & 0x0f, lnz = nz[L] & 0x0f;
  for (int y = 0; y < 4; ++y) {
    uint32_t l = lnz & 1;
    for (int x = 0; x < 4; ++x) {
      int16_t* block = dst + 64 * y + 16 * x;
      const int n = get_coeffs(br, ac, static_cast<int>(l + (tnz & 1)), q[0], first, block);
      l = n > first;
      tnz = (tnz >> 1) | (l << 7);
      non_zero |= n > 1 || block[0] != 0;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (l << 7);
  }
  uint32_t out_t = tnz, out_l = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    tnz = nz[mb_x] >> (4 + ch);
    lnz = nz[L] >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      uint32_t l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        int16_t* block = dst + 256 + 32 * ch + 32 * y + 16 * x;
        const int n = get_coeffs(br, f.bands[2], static_cast<int>(l + (tnz & 1)), q[2], 0, block);
        l = n > 0;
        tnz = (tnz >> 1) | (l << 3);
        non_zero |= n > 1 || block[0] != 0;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (l << 5);
    }
    out_t |= (tnz << 4) << ch;
    out_l |= (lnz & 0xf0) << ch;
  }
  nz[mb_x] = out_t;
  nz[L] = out_l;
  return non_zero;
}

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

// A 4x4 luma prediction into dst (stride bps): dst[-bps - 1] the corner,
// dst[-bps .. -bps + 7] the 8 pixels above, dst[-1 + k * bps] the left ones.
void predict_luma4(int mode, uint8_t* dst, int bps) {
  const uint8_t* t = dst - bps;
  const int X = t[-1], A = t[0], B = t[1], C = t[2], D = t[3], E = t[4], F = t[5], G = t[6], H = t[7];
  const int I = dst[-1], J = dst[bps - 1], K = dst[2 * bps - 1], L = dst[3 * bps - 1];
  int o[4][4];  // [y][x]
  switch (mode) {
    case B_DC: {
      const int v = (A + B + C + D + I + J + K + L + 4) >> 3;
      for (auto& r : o) for (int& p : r) p = v;
      break;
    }
    case B_TM: {
      const int top[4] = {A, B, C, D}, left[4] = {I, J, K, L};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) o[y][x] = clip(top[x] + left[y] - X, 255);
      break;
    }
    case B_VE: {
      const int v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (auto& r : o) for (int x = 0; x < 4; ++x) r[x] = v[x];
      break;
    }
    case B_HE: {
      const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; ++y) for (int& p : o[y]) p = v[y];
      break;
    }
    case B_RD: {
      const int e[9] = {L, K, J, I, X, A, B, C, D};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) o[y][x] = avg3(e[3 + x - y], e[4 + x - y], e[5 + x - y]);
      break;
    }
    case B_LD: {
      const int e[9] = {A, B, C, D, E, F, G, H, H};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) o[y][x] = avg3(e[x + y], e[x + y + 1], e[x + y + 2]);
      break;
    }
    case B_VR: {
      const int v[4][4] = {{avg2(X, A), avg2(A, B), avg2(B, C), avg2(C, D)},
                           {avg3(I, X, A), avg3(X, A, B), avg3(A, B, C), avg3(B, C, D)},
                           {avg3(J, I, X), avg2(X, A), avg2(A, B), avg2(B, C)},
                           {avg3(K, J, I), avg3(I, X, A), avg3(X, A, B), avg3(A, B, C)}};
      std::memcpy(o, v, sizeof(o));
      break;
    }
    case B_VL: {
      const int v[4][4] = {{avg2(A, B), avg2(B, C), avg2(C, D), avg2(D, E)},
                           {avg3(A, B, C), avg3(B, C, D), avg3(C, D, E), avg3(D, E, F)},
                           {avg2(B, C), avg2(C, D), avg2(D, E), avg3(E, F, G)},
                           {avg3(B, C, D), avg3(C, D, E), avg3(D, E, F), avg3(F, G, H)}};
      std::memcpy(o, v, sizeof(o));
      break;
    }
    case B_HD: {
      const int v[4][4] = {{avg2(I, X), avg3(I, X, A), avg3(X, A, B), avg3(A, B, C)},
                           {avg2(J, I), avg3(J, I, X), avg2(I, X), avg3(I, X, A)},
                           {avg2(K, J), avg3(K, J, I), avg2(J, I), avg3(J, I, X)},
                           {avg2(L, K), avg3(L, K, J), avg2(K, J), avg3(K, J, I)}};
      std::memcpy(o, v, sizeof(o));
      break;
    }
    default: {  // B_HU
      const int v[4][4] = {{avg2(I, J), avg3(I, J, K), avg2(J, K), avg3(J, K, L)},
                           {avg2(J, K), avg3(J, K, L), avg2(K, L), avg3(K, L, L)},
                           {avg2(K, L), avg3(K, L, L), L, L},
                           {L, L, L, L}};
      std::memcpy(o, v, sizeof(o));
    }
  }
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) dst[y * bps + x] = static_cast<uint8_t>(o[y][x]);
}

// A 16x16 luma or 8x8 chroma prediction (size n) into dst, laid out as above.
void predict_block(int mode, uint8_t* dst, int bps, int n, int mb_x, int mb_y) {
  const uint8_t* top = dst - bps;
  if (mode == DC_PRED) {
    const int shift = n == 16 ? 4 : 3;
    int v = 0;
    if (mb_x && mb_y) {
      for (int k = 0; k < n; ++k) v += top[k] + dst[k * bps - 1];
      v = (v + n) >> (shift + 1);
    } else if (mb_y) {  // the left column: the top edge alone
      for (int k = 0; k < n; ++k) v += top[k];
      v = (v + n / 2) >> shift;
    } else if (mb_x) {  // the top row: the left edge alone
      for (int k = 0; k < n; ++k) v += dst[k * bps - 1];
      v = (v + n / 2) >> shift;
    } else {
      v = 128;
    }
    for (int y = 0; y < n; ++y) std::memset(dst + y * bps, v, n);
  } else if (mode == TM_PRED) {
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x)
        dst[y * bps + x] = static_cast<uint8_t>(clip(top[x] + dst[y * bps - 1] - top[-1], 255));
  } else if (mode == V_PRED) {
    for (int y = 0; y < n; ++y) std::memcpy(dst + y * bps, top, n);
  } else {  // H_PRED
    for (int y = 0; y < n; ++y) std::memset(dst + y * bps, dst[y * bps - 1], n);
  }
}

// Fill the work area w (stride bps, the block at w + bps + 1) with the n x n
// block's edges from the unfiltered plane: 127 above the top row (the corner
// too), 129 left of the left column (the corner too below the top row).
void load_edges(uint8_t* w, int bps, const uint8_t* plane, int stride, int y0, int x0, int n, int mb_x, int mb_y) {
  uint8_t* top = w + 1;
  if (mb_y) std::memcpy(top, plane + (y0 - 1) * stride + x0, n);
  else std::memset(top, 127, n);
  for (int k = 0; k < n; ++k) w[(k + 1) * bps] = mb_x ? plane[(y0 + k) * stride + x0 - 1] : 129;
  w[0] = !mb_y ? 127 : !mb_x ? 129 : plane[(y0 - 1) * stride + x0 - 1];
}

void reconstruct(Frame& f, int mb, int mb_x, int mb_y) {
  constexpr int bps = 24;
  uint8_t w[17 * bps];
  const int16_t* coeffs = &f.coeffs[384 * static_cast<size_t>(mb)];
  const int y0 = 16 * mb_y, x0 = 16 * mb_x;
  load_edges(w, bps, f.Y.data(), f.ys, y0, x0, 16, mb_x, mb_y);
  uint8_t* blk = w + bps + 1;
  if (f.i4x4[mb]) {
    // the 4 pixels above and to the right, also on rows 3, 7 and 11 for sub-block rows 1-3
    uint8_t* tr = w + 17;
    if (!mb_y) std::memset(tr, 127, 4);
    else if (mb_x == f.mb_w - 1) std::memset(tr, f.Y[(y0 - 1) * f.ys + x0 + 15], 4);
    else std::memcpy(tr, &f.Y[(y0 - 1) * f.ys + x0 + 16], 4);
    for (int r = 4; r <= 12; r += 4) std::memcpy(tr + r * bps, tr, 4);
    for (int k = 0; k < 16; ++k) {
      uint8_t* d = blk + 4 * (k / 4) * bps + 4 * (k % 4);
      predict_luma4(f.modes[16 * mb + k], d, bps);
      inverse_dct_add(coeffs + 16 * k, d, bps);
    }
  } else {
    predict_block(f.modes[16 * mb], blk, bps, 16, mb_x, mb_y);
    for (int k = 0; k < 16; ++k) inverse_dct_add(coeffs + 16 * k, blk + 4 * (k / 4) * bps + 4 * (k % 4), bps);
  }
  for (int r = 0; r < 16; ++r) std::memcpy(&f.Y[(y0 + r) * f.ys + x0], blk + r * bps, 16);
  std::vector<uint8_t>* planes[2] = {&f.U, &f.V};
  for (int c = 0; c < 2; ++c) {
    std::vector<uint8_t>& P = *planes[c];
    load_edges(w, bps, P.data(), f.uvs, y0 / 2, x0 / 2, 8, mb_x, mb_y);
    predict_block(f.uv_mode[mb], blk, bps, 8, mb_x, mb_y);
    for (int k = 0; k < 4; ++k)
      inverse_dct_add(coeffs + 256 + 64 * c + 16 * k, blk + 4 * (k / 2) * bps + 4 * (k % 2), bps);
    for (int r = 0; r < 8; ++r) std::memcpy(&P[(y0 / 2 + r) * f.uvs + x0 / 2], blk + r * bps, 8);
  }
}

// The loop filter on the n pixels of one edge: p points at q0 of the first,
// hstep across the edge, vstep along it.
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void filter2(uint8_t* p, int s) {  // DoFilter2: p0 and q0, with the outer taps
  const int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-s] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

void simple_edge(uint8_t* p, int hstep, int vstep, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstep) {
    if (4 * std::abs(p[-hstep] - p[0]) + std::abs(p[-2 * hstep] - p[hstep]) <= t2) filter2(p, hstep);
  }
}

void complex_edge(uint8_t* p, int s, int vstep, int n, int thresh, int ithresh, int hev_thresh, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < n; ++i, p += vstep) {
    const int p3 = p[-4 * s], p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s];
    const int q0 = p[0], q1 = p[s], q2 = p[2 * s], q3 = p[3 * s];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t2) continue;
    if (std::abs(p3 - p2) > ithresh || std::abs(p2 - p1) > ithresh || std::abs(p1 - p0) > ithresh ||
        std::abs(q3 - q2) > ithresh || std::abs(q2 - q1) > ithresh || std::abs(q1 - q0) > ithresh)
      continue;
    if (std::abs(p1 - p0) > hev_thresh || std::abs(q1 - q0) > hev_thresh) {
      filter2(p, s);
    } else if (mb_edge) {  // DoFilter6
      const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
      const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
      p[-3 * s] = clip8(p2 + a3);
      p[-2 * s] = clip8(p1 + a2);
      p[-s] = clip8(p0 + a1);
      p[0] = clip8(q0 - a1);
      p[s] = clip8(q1 - a2);
      p[2 * s] = clip8(q2 - a3);
    } else {  // DoFilter4
      const int a = 3 * (q0 - p0);
      const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
      p[-2 * s] = clip8(p1 + a3);
      p[-s] = clip8(p0 + a2);
      p[0] = clip8(q0 - a1);
      p[s] = clip8(q1 - a3);
    }
  }
}

void loop_filter(Frame& f) {
  int limits[4][2][3];  // PrecomputeFilterStrengths: (limit, interior limit, hev threshold); limit 0: none
  for (int s = 0; s < 4; ++s) {
    const int base = f.use_segment ? f.strength[s] + (f.absolute ? 0 : f.level) : f.level;
    for (int i4 = 0; i4 < 2; ++i4) {
      int level = base;
      if (f.use_lf_delta) level += f.ref_delta[0] + (i4 ? f.mode_delta[0] : 0);
      level = clip(level, 63);
      int* out = limits[s][i4];
      if (!level) {
        out[0] = out[1] = out[2] = 0;
        continue;
      }
      int ilevel = level;
      if (f.sharpness > 0) {
        ilevel >>= f.sharpness > 4 ? 2 : 1;
        ilevel = std::min(ilevel, 9 - f.sharpness);
      }
      ilevel = std::max(ilevel, 1);
      out[0] = 2 * level + ilevel;
      out[1] = ilevel;
      out[2] = level >= 40 ? 2 : level >= 15 ? 1 : 0;
    }
  }
  const int ys = f.ys, uvs = f.uvs;
  for (int mb_y = 0; mb_y < f.mb_h; ++mb_y) {
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
      const int mb = mb_y * f.mb_w + mb_x;
      const int* lim = limits[f.segment[mb]][f.i4x4[mb]];
      const int limit = lim[0], ilevel = lim[1], hev = lim[2];
      if (!limit) continue;
      uint8_t* y = &f.Y[16 * mb_y * ys + 16 * mb_x];
      const bool inner = f.inner[mb];
      if (f.simple) {
        if (mb_x) simple_edge(y, 1, ys, limit + 4);
        if (inner)
          for (int k = 4; k < 16; k += 4) simple_edge(y + k, 1, ys, limit);
        if (mb_y) simple_edge(y, ys, 1, limit + 4);
        if (inner)
          for (int k = 4; k < 16; k += 4) simple_edge(y + k * ys, ys, 1, limit);
        continue;
      }
      uint8_t* uv[2] = {&f.U[8 * mb_y * uvs + 8 * mb_x], &f.V[8 * mb_y * uvs + 8 * mb_x]};
      if (mb_x) {
        complex_edge(y, 1, ys, 16, limit + 4, ilevel, hev, true);
        for (uint8_t* c : uv) complex_edge(c, 1, uvs, 8, limit + 4, ilevel, hev, true);
      }
      if (inner) {
        for (int k = 4; k < 16; k += 4) complex_edge(y + k, 1, ys, 16, limit, ilevel, hev, false);
        for (uint8_t* c : uv) complex_edge(c + 4, 1, uvs, 8, limit, ilevel, hev, false);
      }
      if (mb_y) {
        complex_edge(y, ys, 1, 16, limit + 4, ilevel, hev, true);
        for (uint8_t* c : uv) complex_edge(c, uvs, 1, 8, limit + 4, ilevel, hev, true);
      }
      if (inner) {
        for (int k = 4; k < 16; k += 4) complex_edge(y + k * ys, ys, 1, 16, limit, ilevel, hev, false);
        for (uint8_t* c : uv) complex_edge(c + 4 * uvs, uvs, 1, 8, limit, ilevel, hev, false);
      }
    }
  }
}

inline int mulhi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v >> 6) > 255 ? 255 : v >> 6); }

// One output row of fancy upsampling: near is the chroma row weighed 3, far
// the one weighed 1 (u and v each), y the luma row; rgb receives 3 x width.
void upsample_row(const uint8_t* y, const uint8_t* nu, const uint8_t* fu, const uint8_t* nv, const uint8_t* fv,
                  int width, uint8_t* rgb) {
  auto put = [&](int x, int u, int v) {
    const int yy = mulhi(y[x], 19077);
    rgb[3 * x + 0] = yuv_clip(yy + mulhi(v, 26149) - 14234);
    rgb[3 * x + 1] = yuv_clip(yy - mulhi(u, 6419) - mulhi(v, 13320) + 8708);
    rgb[3 * x + 2] = yuv_clip(yy + mulhi(u, 33050) - 17685);
  };
  put(0, (3 * nu[0] + fu[0] + 2) >> 2, (3 * nv[0] + fv[0] + 2) >> 2);
  const int pairs = (width - 1) >> 1;
  for (int x = 1; x <= pairs; ++x) {
    const int su = nu[x - 1] + nu[x] + fu[x - 1] + fu[x] + 8, sv = nv[x - 1] + nv[x] + fv[x - 1] + fv[x] + 8;
    put(2 * x - 1, (((su + 2 * (nu[x] + fu[x - 1])) >> 3) + nu[x - 1]) >> 1,
        (((sv + 2 * (nv[x] + fv[x - 1])) >> 3) + nv[x - 1]) >> 1);
    put(2 * x, (((su + 2 * (nu[x - 1] + fu[x])) >> 3) + nu[x]) >> 1,
        (((sv + 2 * (nv[x - 1] + fv[x])) >> 3) + nv[x]) >> 1);
  }
  if (!(width & 1)) {
    put(width - 1, (3 * nu[pairs] + fu[pairs] + 2) >> 2, (3 * nv[pairs] + fv[pairs] + 2) >> 2);
  }
}

int64_t decode(const uint8_t* data, int64_t n, int width, int height, uint8_t* rgb) {
  if (n < 10) return kTruncated;
  const uint32_t tag = data[0] | data[1] << 8 | data[2] << 16;
  const int w = (data[6] | data[7] << 8) & 0x3fff, h = (data[8] | data[9] << 8) & 0x3fff;
  if ((tag & 1) || ((tag >> 1) & 7) > 3 || !((tag >> 4) & 1) || data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a ||
      w != width || h != height || !w || !h)
    return kBadCode;
  const int64_t first = tag >> 5;
  if (10 + first > n) return kTruncated;
  Frame f;
  f.width = width;
  f.height = height;
  f.mb_w = (width + 15) >> 4;
  f.mb_h = (height + 15) >> 4;
  f.br = Bits(data, 10, 10 + first);
  parse_header(f, data, n);
  const int count = f.mb_w * f.mb_h, last = static_cast<int>(f.parts.size()) - 1;
  f.segment.assign(count, 0);
  f.i4x4.assign(count, 0);
  f.inner.assign(count, 0);
  f.uv_mode.assign(count, 0);
  f.modes.assign(16 * static_cast<size_t>(count), 0);
  f.coeffs.assign(384 * static_cast<size_t>(count), 0);
  std::vector<uint8_t> intra_t(4 * static_cast<size_t>(f.mb_w), B_DC), skip(f.mb_w);
  std::vector<uint32_t> nz(f.mb_w + 1, 0);
  std::vector<uint8_t> nz_dc(f.mb_w + 1, 0);
  for (int mb_y = 0; mb_y < f.mb_h; ++mb_y) {
    uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x)
      skip[mb_x] = static_cast<uint8_t>(parse_modes(f, mb_y * f.mb_w + mb_x, &intra_t[4 * mb_x], intra_l));
    Bits& tokens = f.parts[mb_y & last];
    nz[f.mb_w] = 0;
    nz_dc[f.mb_w] = 0;
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
      const int mb = mb_y * f.mb_w + mb_x;
      bool coded = false;
      if (!skip[mb_x]) {
        coded = parse_residuals(f, tokens, mb, mb_x, nz, nz_dc);
      } else {
        nz[mb_x] = nz[f.mb_w] = 0;
        if (!f.i4x4[mb]) nz_dc[mb_x] = nz_dc[f.mb_w] = 0;
      }
      tokens.check();
      f.inner[mb] = f.i4x4[mb] || coded;
    }
  }
  f.ys = 16 * f.mb_w;
  f.uvs = 8 * f.mb_w;
  f.Y.assign(static_cast<size_t>(f.ys) * 16 * f.mb_h, 0);
  f.U.assign(static_cast<size_t>(f.uvs) * 8 * f.mb_h, 0);
  f.V.assign(static_cast<size_t>(f.uvs) * 8 * f.mb_h, 0);
  for (int mb_y = 0; mb_y < f.mb_h; ++mb_y)
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) reconstruct(f, mb_y * f.mb_w + mb_x, mb_x, mb_y);
  if (f.level) loop_filter(f);
  // rows 2k - 1 and 2k weigh chroma rows k - 1 and k, 3:1 towards the nearer; row 0 and an even height's last row
  // weigh their chroma row alone
  const int ch = (height + 1) / 2;
  for (int r = 0; r < height; ++r) {
    const int k = (r + 1) / 2;
    const bool top_part = (r & 1) || r == 0;
    const int a = std::max(k - 1, 0), b = std::min(k, ch - 1);
    const int near = top_part ? a : b, far = top_part ? b : a;
    upsample_row(&f.Y[static_cast<size_t>(r) * f.ys], &f.U[static_cast<size_t>(near) * f.uvs],
                 &f.U[static_cast<size_t>(far) * f.uvs], &f.V[static_cast<size_t>(near) * f.uvs],
                 &f.V[static_cast<size_t>(far) * f.uvs], width, rgb + 3 * static_cast<size_t>(r) * width);
  }
  return 0;
}

}  // namespace

// src: the n bytes of a VP8 key frame from its frame tag to the end of what
// libwebp is given; rgb: height x width x 3 bytes, top row first. Returns 0,
// kBadCode (a frame tag or header that libwebp refuses) or kTruncated.
extern "C" int64_t vp8_decode(const uint8_t* src, int64_t n, int64_t width, int64_t height, uint8_t* rgb) {
  try {
    return decode(src, n, static_cast<int>(width), static_cast<int>(height), rgb);
  } catch (const Fail& e) {
    return e.code;
  }
}
