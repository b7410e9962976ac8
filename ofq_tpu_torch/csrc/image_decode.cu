// JPEG decoding on the card through nvJPEG (the CUDA toolkit's library).
//
// Replaces no TPU kernel: it stands where the JAX package's input pipeline
// calls TensorFlow's host decoder, `tf.io.decode_image(..., channels=3,
// expand_animations=False)` (ofq_tpu/data/pipeline.py, load_train and
// load_eval).  It is a library call behind a plain C interface, built and
// loaded with ctypes like the kernels of this directory, linked with
// -lnvjpeg (ops/_build.py, LINK_FLAGS).
//
// One decoder (nvJPEG handle and state) per process and device, made by
// ofq_jpeg_open.  ofq_jpeg_info reads the header: components, chroma
// subsampling, width and height, and whether the frame is progressive
// (SOF2).  ofq_jpeg_decode decodes one image into interleaved RGB uint8
// (H, W, 3) at `out`, a buffer on the device that the caller allocated, on
// the caller's stream.  nvJPEG's default backend decodes the Huffman
// stream on the host and runs dequantization, IDCT, upsampling and colour
// conversion on the card; a grayscale frame comes out as three equal
// channels.
//
// What bounds it: per image the host's Huffman decoding (one thread), not
// the card; the device part moves H * W * 3 bytes out.
//
// A 4-component frame (CMYK, or YCCK under an Adobe APP14 marker whose
// transform byte is not 0): nvJPEG's interleaved RGB output refuses it, so
// ofq_jpeg_decode_planes decodes it to its four planes as stored
// (NVJPEG_OUTPUT_UNCHANGED, each at its own sampled size) and
// ofq_cmyk_to_rgb, the one hand-written kernel of this file, writes the
// (H, W, 3) uint8 image as TensorFlow's libjpeg decode gives it
// (tensorflow/core/lib/jpeg/jpeg_mem.cc): YCCK first to CMYK by libjpeg's
// fixed-point YCC->RGB tables (jdcolor.c, ycck_cmyk_convert: each of
// C, M, Y is 255 - R, G, B), then TensorFlow's integer CMYK->RGB, R = C *
// K / 255 with an Adobe marker (its inverted CMYK), R = (255 - C) * (255 -
// K) / 255 without.  A plane sampled below the image size is read at
// floor(x * w / W), floor(y * h / H): replication, not libjpeg's "fancy"
// triangular upsampling (every 4-component file PIL and Photoshop write
// is 4:4:4).  The kernel moves 4 + 3 bytes a pixel: it is bound by bytes.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>

namespace {

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
};

// the frame's start-of-frame marker: 0xC2 (progressive, Huffman) or any
// other SOFn; returns 1 for progressive, 0 for baseline or extended, -1
// when no SOF marker is found
int progressive(const unsigned char* d, size_t n) {
  size_t i = 2;
  while (i + 4 <= n) {
    if (d[i] != 0xFF) return -1;
    const unsigned char m = d[i + 1];
    if (m == 0xFF) {  // fill byte
      ++i;
      continue;
    }
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      i += 2;
      continue;
    }
    const size_t len = (size_t(d[i + 2]) << 8) | d[i + 3];
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC)
      return (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) ? 1 : 0;
    if (m == 0xDA) return -1;  // scan before any frame header
    i += 2 + len;
  }
  return -1;
}

}  // namespace

extern "C" int ofq_jpeg_open(void** out) {
  Decoder* dec = new Decoder();
  nvjpegStatus_t st = nvjpegCreateSimple(&dec->handle);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegJpegStateCreate(dec->handle, &dec->state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    if (dec->handle) nvjpegDestroy(dec->handle);
    delete dec;
    *out = nullptr;
    return int(st);
  }
  *out = dec;
  return 0;
}

extern "C" void ofq_jpeg_close(void* h) {
  Decoder* dec = static_cast<Decoder*>(h);
  if (dec == nullptr) return;
  if (dec->state) nvjpegJpegStateDestroy(dec->state);
  if (dec->handle) nvjpegDestroy(dec->handle);
  delete dec;
}

// info: [components, subsampling (nvjpegChromaSubsampling_t), width,
// height, progressive (1, 0, or -1 when unknown), then the width and the
// height of each of the 4 components (0 past the last)]
extern "C" int ofq_jpeg_info(void* h, const unsigned char* data, size_t n,
                             int* info) {
  Decoder* dec = static_cast<Decoder*>(h);
  int ncomp = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  const nvjpegStatus_t st = nvjpegGetImageInfo(dec->handle, data, n, &ncomp,
                                               &css, widths, heights);
  if (st != NVJPEG_STATUS_SUCCESS) return int(st);
  info[0] = ncomp;
  info[1] = int(css);
  info[2] = widths[0];
  info[3] = heights[0];
  info[4] = progressive(data, n);
  for (int c = 0; c < 4; ++c) {
    info[5 + 2 * c] = c < ncomp ? widths[c] : 0;
    info[6 + 2 * c] = c < ncomp ? heights[c] : 0;
  }
  return 0;
}

// out: width * height * 3 bytes on the device, rows of 3 * width bytes
extern "C" int ofq_jpeg_decode(void* h, const unsigned char* data, size_t n,
                               unsigned char* out, int width, void* stream) {
  Decoder* dec = static_cast<Decoder*>(h);
  nvjpegImage_t img;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    img.channel[c] = nullptr;
    img.pitch[c] = 0;
  }
  img.channel[0] = out;
  img.pitch[0] = size_t(width) * 3;
  return int(nvjpegDecode(dec->handle, dec->state, data, n,
                          NVJPEG_OUTPUT_RGBI, &img,
                          static_cast<cudaStream_t>(stream)));
}

// A 4-component frame's planes as stored: plane c at planes[c], rows of
// pitches[c] bytes (at least its width).
extern "C" int ofq_jpeg_decode_planes(void* h, const unsigned char* data,
                                      size_t n, unsigned char** planes,
                                      const int* pitches, void* stream) {
  Decoder* dec = static_cast<Decoder*>(h);
  nvjpegImage_t img;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    img.channel[c] = c < 4 ? planes[c] : nullptr;
    img.pitch[c] = c < 4 ? size_t(pitches[c]) : 0;
  }
  return int(nvjpegDecode(dec->handle, dec->state, data, n,
                          NVJPEG_OUTPUT_UNCHANGED, &img,
                          static_cast<cudaStream_t>(stream)));
}

namespace {

// libjpeg's build_ycc_rgb_table (jdcolor.c): SCALEBITS 16, FIX(x) = x *
// 2^16 rounded, arithmetic right shifts
constexpr int kScale = 16;
constexpr int kHalf = 1 << (kScale - 1);
constexpr int kCrR = 91881;   // FIX(1.40200)
constexpr int kCbB = 116130;  // FIX(1.77200)
constexpr int kCrG = 46802;   // FIX(0.71414)
constexpr int kCbG = 22554;   // FIX(0.34414)

struct Planes {
  const unsigned char* p[4];
  int pitch[4], w[4], h[4];
};

__device__ __forceinline__ int clamp255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

__global__ void cmyk_to_rgb_kernel(Planes pl, int ycck, int adobe,
                                   unsigned char* out, int W, int H) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W || y >= H) return;
  int v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int xs = pl.w[c] == W ? x : int((long long)x * pl.w[c] / W);
    const int ys = pl.h[c] == H ? y : int((long long)y * pl.h[c] / H);
    v[c] = pl.p[c][size_t(ys) * pl.pitch[c] + xs];
  }
  if (ycck) {
    const int yy = v[0], cb = v[1] - 128, cr = v[2] - 128;
    const int r = yy + ((kCrR * cr + kHalf) >> kScale);
    const int g = yy + ((-kCbG * cb + kHalf - kCrG * cr) >> kScale);
    const int b = yy + ((kCbB * cb + kHalf) >> kScale);
    v[0] = clamp255(255 - r);
    v[1] = clamp255(255 - g);
    v[2] = clamp255(255 - b);
  }
  unsigned char* o = out + (size_t(y) * W + x) * 3;
  const int k = v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    o[c] = (unsigned char)(adobe ? v[c] * k / 255
                                 : (255 - v[c]) * (255 - k) / 255);
}

}  // namespace

// The (H, W, 3) uint8 image of a 4-component frame's planes (see the
// header): ycck 1 converts YCCK first; adobe 1 takes the Adobe rule.
extern "C" int ofq_cmyk_to_rgb(const unsigned char** planes,
                               const int* pitches, const int* widths,
                               const int* heights, int ycck, int adobe,
                               unsigned char* out, int W, int H,
                               void* stream) {
  Planes pl;
  for (int c = 0; c < 4; ++c) {
    pl.p[c] = planes[c];
    pl.pitch[c] = pitches[c];
    pl.w[c] = widths[c];
    pl.h[c] = heights[c];
  }
  const dim3 block(128);
  const dim3 grid((W + 127) / 128, H);
  cmyk_to_rgb_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      pl, ycck, adobe, out, W, H);
  return int(cudaGetLastError());
}

extern "C" const char* ofq_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
