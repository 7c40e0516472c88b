// JPEG decode and encode on the card through nvJPEG (the CUDA toolkit's
// codec library), behind a plain C interface loaded with ctypes.
//
// Replaces no TPU kernel: the reference decodes and encodes with Pillow on
// the host (mxnet_tpu/image/__init__.py:81 imdecode, recordio.py:260
// pack_img) and ships only the finished batch to the device. The port
// decodes on the card instead, so the host keeps no decode workers. nvJPEG
// is a library of the toolkit, used as cuDNN is for convolution: nothing
// here is a kernel of this repository, and PERF.md's kernel table has no
// row for it.
//
// What bounds it on an H100: for baseline files the hardware decoder
// (NVJPG engines, NVJPEG_BACKEND_HARDWARE) does the Huffman decode, the
// IDCT and the colour conversion; for what those engines do not take
// (progressive files, 4:1:1), NVJPEG_BACKEND_GPU_HYBRID decodes the
// Huffman data on the host for small files and with CUDA kernels for large
// ones. The wrapper (kernels/jpeg.py) chooses between the two per batch
// and records which one ran.
//
// Conventions: every entry returns 0 or an error code, a CUDA error as is
// and an nvJPEG status as 1000 + status; mx_error_string names either.
// Outputs are tensors the wrapper allocated with torch, written on the
// stream it passes (torch's current stream). One handle per device is
// shared by all threads; a decode state belongs to one thread at a time
// (nvJPEG's states are not thread-safe), and so does an encoder state.
#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>
#include <vector>

namespace {

constexpr int kNvjpegBase = 1000;
constexpr int kBufferTooSmall = 2000;

#define NVJ(call)                                             \
  do {                                                        \
    nvjpegStatus_t s_ = (call);                               \
    if (s_ != NVJPEG_STATUS_SUCCESS) return kNvjpegBase + s_; \
  } while (0)

inline nvjpegHandle_t H(void* h) { return static_cast<nvjpegHandle_t>(h); }
inline nvjpegJpegState_t S(void* s) {
  return static_cast<nvjpegJpegState_t>(s);
}
inline cudaStream_t St(void* s) { return static_cast<cudaStream_t>(s); }

struct Encoder {
  nvjpegEncoderState_t state = nullptr;
  nvjpegEncoderParams_t params = nullptr;
};

}  // namespace

extern "C" {

const char* mx_error_string(int code) {
  if (code == kBufferTooSmall) return "encoded JPEG larger than its buffer";
  if (code >= kNvjpegBase) {
    switch (code - kNvjpegBase) {
      case NVJPEG_STATUS_NOT_INITIALIZED: return "NVJPEG_STATUS_NOT_INITIALIZED";
      case NVJPEG_STATUS_INVALID_PARAMETER: return "NVJPEG_STATUS_INVALID_PARAMETER";
      case NVJPEG_STATUS_BAD_JPEG: return "NVJPEG_STATUS_BAD_JPEG";
      case NVJPEG_STATUS_JPEG_NOT_SUPPORTED: return "NVJPEG_STATUS_JPEG_NOT_SUPPORTED";
      case NVJPEG_STATUS_ALLOCATOR_FAILURE: return "NVJPEG_STATUS_ALLOCATOR_FAILURE";
      case NVJPEG_STATUS_EXECUTION_FAILED: return "NVJPEG_STATUS_EXECUTION_FAILED";
      case NVJPEG_STATUS_ARCH_MISMATCH: return "NVJPEG_STATUS_ARCH_MISMATCH";
      case NVJPEG_STATUS_INTERNAL_ERROR: return "NVJPEG_STATUS_INTERNAL_ERROR";
      case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED:
        return "NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED";
      case NVJPEG_STATUS_INCOMPLETE_BITSTREAM: return "NVJPEG_STATUS_INCOMPLETE_BITSTREAM";
      default: return "nvJPEG error";
    }
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// nvJPEG's version as major * 1000 + minor * 10 + patch.
int mx_jpeg_version(int* version) {
  int major = 0, minor = 0, patch = 0;
  NVJ(nvjpegGetProperty(MAJOR_VERSION, &major));
  NVJ(nvjpegGetProperty(MINOR_VERSION, &minor));
  NVJ(nvjpegGetProperty(PATCH_LEVEL, &patch));
  *version = major * 1000 + minor * 10 + patch;
  return 0;
}

// A handle of `backend` (nvjpegBackend_t) on the current device, with the
// given NVJPEG_FLAGS_*. A backend the card or the library does not offer
// returns its status (NVJPEG_STATUS_ARCH_MISMATCH, ...).
int mx_jpeg_create(int backend, unsigned int flags, void** handle) {
  nvjpegHandle_t h = nullptr;
  NVJ(nvjpegCreateEx(static_cast<nvjpegBackend_t>(backend), nullptr,
                     nullptr, flags, &h));
  *handle = h;
  return 0;
}

int mx_jpeg_destroy(void* handle) {
  NVJ(nvjpegDestroy(H(handle)));
  return 0;
}

int mx_jpeg_state_create(void* handle, void** state) {
  nvjpegJpegState_t s = nullptr;
  NVJ(nvjpegJpegStateCreate(H(handle), &s));
  *state = s;
  return 0;
}

int mx_jpeg_state_destroy(void* state) {
  NVJ(nvjpegJpegStateDestroy(S(state)));
  return 0;
}

// Components, chroma subsampling (nvjpegChromaSubsampling_t) and the size
// of the first component, from the file's header; no device work.
int mx_jpeg_info(void* handle, const unsigned char* data, size_t length,
                 int* components, int* subsampling, int* width,
                 int* height) {
  int w[NVJPEG_MAX_COMPONENT] = {0}, h[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t css = NVJPEG_CSS_UNKNOWN;
  NVJ(nvjpegGetImageInfo(H(handle), data, length, components, &css, w, h));
  *subsampling = static_cast<int>(css);
  *width = w[0];
  *height = h[0];
  return 0;
}

// 1 in *supported when the handle's batched decoder takes this file (the
// hardware backend takes baseline files with one scan and no 4:1:0/4:1:1).
int mx_jpeg_batched_supported(void* handle, const unsigned char* data,
                              size_t length, int* supported) {
  nvjpegJpegStream_t js = nullptr;
  NVJ(nvjpegJpegStreamCreate(H(handle), &js));
  nvjpegStatus_t s = nvjpegJpegStreamParse(H(handle), data, length, 0, 0, js);
  int answer = 1;  // nvJPEG's convention: 0 means supported
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegDecodeBatchedSupported(H(handle), js, &answer);
  nvjpegJpegStreamDestroy(js);
  if (s != NVJPEG_STATUS_SUCCESS) return kNvjpegBase + s;
  *supported = answer == 0 ? 1 : 0;
  return 0;
}

// One file into `out`: interleaved (H, W, 3) for NVJPEG_OUTPUT_RGBI/BGRI,
// (H, W) for NVJPEG_OUTPUT_Y, rows `pitch` bytes apart.
int mx_jpeg_decode(void* handle, void* state, const unsigned char* data,
                   size_t length, int output_format, unsigned char* out,
                   size_t pitch, void* stream) {
  nvjpegImage_t img = {};
  img.channel[0] = out;
  img.pitch[0] = pitch;
  NVJ(nvjpegDecode(H(handle), S(state), data, length,
                   static_cast<nvjpegOutputFormat_t>(output_format), &img,
                   St(stream)));
  return static_cast<int>(cudaGetLastError());
}

// `n` files into `outs[i]` (rows `pitches[i]` bytes apart) in one batched
// call. `initialize` re-initialises the state for (n, output_format); the
// wrapper asks for it when either changed since the state's last call.
int mx_jpeg_decode_batched(void* handle, void* state, int n,
                           const unsigned char* const* data,
                           const size_t* lengths, int output_format,
                           unsigned char* const* outs, const size_t* pitches,
                           int initialize, void* stream) {
  if (initialize)
    NVJ(nvjpegDecodeBatchedInitialize(
        H(handle), S(state), n, 1,
        static_cast<nvjpegOutputFormat_t>(output_format)));
  std::vector<nvjpegImage_t> imgs(n);
  for (int i = 0; i < n; ++i) {
    imgs[i] = nvjpegImage_t{};
    imgs[i].channel[0] = outs[i];
    imgs[i].pitch[0] = pitches[i];
  }
  NVJ(nvjpegDecodeBatched(H(handle), S(state), data, lengths, imgs.data(),
                          St(stream)));
  return static_cast<int>(cudaGetLastError());
}

int mx_jpeg_encoder_create(void* handle, void* stream, void** encoder) {
  Encoder* e = new Encoder();
  nvjpegStatus_t s = nvjpegEncoderStateCreate(H(handle), &e->state, St(stream));
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderParamsCreate(H(handle), &e->params, St(stream));
  if (s != NVJPEG_STATUS_SUCCESS) {
    if (e->state) nvjpegEncoderStateDestroy(e->state);
    delete e;
    return kNvjpegBase + s;
  }
  *encoder = e;
  return 0;
}

int mx_jpeg_encoder_destroy(void* encoder) {
  Encoder* e = static_cast<Encoder*>(encoder);
  nvjpegEncoderParamsDestroy(e->params);
  nvjpegEncoderStateDestroy(e->state);
  delete e;
  return 0;
}

// Encode an (H, W, 3) interleaved RGB image (channels 3; 4:2:0 chroma, as
// Pillow's default for RGB) or an (H, W) grayscale one (channels 1) at
// `quality` on `stream`; the stream is synchronised and the file copied
// into the host buffer `out` of `capacity` bytes, its size in *length.
int mx_jpeg_encode(void* handle, void* encoder, const unsigned char* img,
                   size_t pitch, int width, int height, int channels,
                   int quality, int subsampling, void* stream,
                   unsigned char* out, size_t capacity, size_t* length) {
  Encoder* e = static_cast<Encoder*>(encoder);
  cudaStream_t s = St(stream);
  nvjpegChromaSubsampling_t css =
      channels == 1 ? NVJPEG_CSS_GRAY
                    : static_cast<nvjpegChromaSubsampling_t>(subsampling);
  NVJ(nvjpegEncoderParamsSetQuality(e->params, quality, s));
  NVJ(nvjpegEncoderParamsSetSamplingFactors(e->params, css, s));
  NVJ(nvjpegEncoderParamsSetOptimizedHuffman(e->params, 0, s));
  nvjpegImage_t src = {};
  src.channel[0] = const_cast<unsigned char*>(img);
  src.pitch[0] = pitch;
  if (channels == 1) {
    NVJ(nvjpegEncodeYUV(H(handle), e->state, e->params, &src,
                        NVJPEG_CSS_GRAY, width, height, s));
  } else {
    NVJ(nvjpegEncodeImage(H(handle), e->state, e->params, &src,
                          NVJPEG_INPUT_RGBI, width, height, s));
  }
  size_t n = 0;
  NVJ(nvjpegEncodeRetrieveBitstream(H(handle), e->state, nullptr, &n, s));
  cudaError_t err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > capacity) {
    *length = n;
    return kBufferTooSmall;
  }
  NVJ(nvjpegEncodeRetrieveBitstream(H(handle), e->state, out, &n, s));
  err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return static_cast<int>(err);
  *length = n;
  return 0;
}

}  // extern "C"
