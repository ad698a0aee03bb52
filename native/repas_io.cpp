// repas_io — native host-side I/O runtime for repas_tpu.
//
// Role: the reference delegates image decode and geometry I/O to native
// libraries (OpenCV imread/imdecode, Open3D PLY I/O — SURVEY.md §2.1 N2/N3);
// this library is the equivalent native layer for the framework's host
// side: a zlib-based PNG codec (8-bit gray/RGB/RGBA + 16-bit gray depth
// images) and a std::thread batch loader that decodes a capture batch in
// parallel before device upload.  Exposed via a C ABI for ctypes.
//
// Build: make -C native  (produces librepas_io.so)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct PngInfo {
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = 0, channels = 0;
  int interlace = 0;
};

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int channels_for(int color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // rgb
    case 4: return 2;  // gray+alpha
    case 6: return 4;  // rgba
    default: return 0; // palette unsupported
  }
}

const uint8_t kSig[8] = {137, 'P', 'N', 'G', '\r', '\n', 26, '\n'};

bool parse_header(const uint8_t* buf, size_t len, PngInfo* info) {
  if (len < 33 || memcmp(buf, kSig, 8) != 0) return false;
  const uint8_t* p = buf + 8;
  if (be32(p) != 13 || memcmp(p + 4, "IHDR", 4) != 0) return false;
  info->width = be32(p + 8);
  info->height = be32(p + 12);
  info->bit_depth = p[16];
  info->color_type = p[17];
  info->interlace = p[20];
  info->channels = channels_for(info->color_type);
  return info->channels > 0 && info->interlace == 0 &&
         (info->bit_depth == 8 || info->bit_depth == 16);
}

// collect and inflate all IDAT chunks
bool inflate_idat(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                  size_t expect) {
  out->resize(expect);
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_out = out->data();
  zs.avail_out = static_cast<uInt>(expect);

  const uint8_t* p = buf + 8;
  const uint8_t* end = buf + len;
  bool ok = false;
  while (p + 8 <= end) {
    uint32_t clen = be32(p);
    if (p + 12 + clen > end) break;
    if (memcmp(p + 4, "IDAT", 4) == 0) {
      zs.next_in = const_cast<uint8_t*>(p + 8);
      zs.avail_in = clen;
      int r = inflate(&zs, Z_NO_FLUSH);
      if (r == Z_STREAM_END) { ok = true; break; }
      if (r != Z_OK) break;
    } else if (memcmp(p + 4, "IEND", 4) == 0) {
      ok = (zs.avail_out == 0);
      break;
    }
    p += 12 + clen;
  }
  ok = ok || (zs.avail_out == 0);
  inflateEnd(&zs);
  return ok;
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

// reverse per-row PNG filters in place into dst (no filter bytes)
void unfilter(const std::vector<uint8_t>& raw, uint8_t* dst,
              const PngInfo& info) {
  const size_t bpp = size_t(info.channels) * info.bit_depth / 8;
  const size_t stride = size_t(info.width) * bpp;
  const uint8_t* src = raw.data();
  for (uint32_t y = 0; y < info.height; ++y) {
    uint8_t filter = src[y * (stride + 1)];
    const uint8_t* row = src + y * (stride + 1) + 1;
    uint8_t* out = dst + y * stride;
    const uint8_t* prev = (y > 0) ? dst + (y - 1) * stride : nullptr;
    switch (filter) {
      case 0:
        memcpy(out, row, stride);
        break;
      case 1:  // sub
        for (size_t i = 0; i < stride; ++i)
          out[i] = uint8_t(row[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:  // up
        for (size_t i = 0; i < stride; ++i)
          out[i] = uint8_t(row[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // average
        for (size_t i = 0; i < stride; ++i) {
          int a = (i >= bpp) ? out[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          out[i] = uint8_t(row[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // paeth
        for (size_t i = 0; i < stride; ++i) {
          int a = (i >= bpp) ? out[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          out[i] = uint8_t(row[i] + paeth(a, b, c));
        }
        break;
      default:
        memset(out, 0, stride);
    }
  }
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  if (n < 0) {  // unseekable stream (pipe/fifo): ftell yields -1
    fclose(f);
    return false;
  }
  fseek(f, 0, SEEK_SET);
  buf->resize(size_t(n));
  size_t got = fread(buf->data(), 1, size_t(n), f);
  fclose(f);
  return got == size_t(n);
}

int decode_into(const uint8_t* buf, size_t len, uint8_t* out,
                PngInfo* info) {
  if (!parse_header(buf, len, info)) return -1;
  const size_t bpp = size_t(info->channels) * info->bit_depth / 8;
  const size_t stride = size_t(info->width) * bpp;
  std::vector<uint8_t> raw;
  if (!inflate_idat(buf, len, &raw, (stride + 1) * info->height)) return -2;
  unfilter(raw, out, *info);
  // PNG 16-bit samples are big-endian; emit host little-endian
  if (info->bit_depth == 16) {
    size_t n = stride * info->height;
    for (size_t i = 0; i + 1 < n; i += 2) {
      uint8_t t = out[i];
      out[i] = out[i + 1];
      out[i + 1] = t;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Query image dimensions. Returns 0 on success (decodable by this codec).
int repas_png_info(const char* path, int* width, int* height, int* channels,
                   int* bit_depth) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  PngInfo info;
  if (!parse_header(buf.data(), buf.size(), &info)) return -2;
  *width = int(info.width);
  *height = int(info.height);
  *channels = info.channels;
  *bit_depth = info.bit_depth;
  return 0;
}

// Decode into caller-allocated buffer of
// width*height*channels*(bit_depth/8) bytes. Returns 0 on success.
int repas_png_decode(const char* path, uint8_t* out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  PngInfo info;
  return decode_into(buf.data(), buf.size(), out, &info);
}

// Parallel batch decode: n same-format images into a contiguous buffer of
// n * frame_bytes. statuses[i] = per-file result. Thread pool sized to
// hardware concurrency (the "data-loader" runtime role).
void repas_png_decode_batch(const char** paths, int n, uint8_t* out,
                            long frame_bytes, int* statuses, int n_threads) {
  if (n_threads <= 0) {
    n_threads = int(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 2;
  }
  std::vector<std::thread> workers;
  std::vector<int> next_idx(1, 0);
  auto work = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      statuses[i] = repas_png_decode(paths[i], out + long(i) * frame_bytes);
    }
  };
  for (int t = 0; t < n_threads; ++t) workers.emplace_back(work, t);
  for (auto& w : workers) w.join();
}

// CRC-32 helper (zlib) — exposed for PNG writing from Python.
unsigned long repas_crc32(const uint8_t* buf, long len, unsigned long seed) {
  return crc32(seed, buf, uInt(len));
}

// Raw zlib compress for PNG IDAT writing. Returns compressed size or <0.
long repas_zlib_compress(const uint8_t* in, long in_len, uint8_t* out,
                         long out_cap, int level) {
  uLongf dest_len = uLongf(out_cap);
  int r = compress2(out, &dest_len, in, uLong(in_len), level);
  return (r == Z_OK) ? long(dest_len) : -1;
}

}  // extern "C"
