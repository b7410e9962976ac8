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
// height, progressive (1, 0, or -1 when unknown)]
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

extern "C" const char* ofq_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
