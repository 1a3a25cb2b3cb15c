// RecordIO frames and the libjpeg decode route of mxnet_tpu_torch.
//
// The reference's C++ input stack, as a flat C ABI loaded with ctypes
// (mxnet_tpu_torch/_native.py, io/image_record.py):
//   - dmlc recordio frame parsing (reference interface dmlc/recordio.h,
//     consumed by src/io/iter_image_recordio_2.cc ParseChunk)
//   - parallel JPEG decode + augment (reference
//     src/io/iter_image_recordio_2.cc:79-146): a std::thread pool
//     decoding via libjpeg with resize-short-edge + crop + mirror fused
//     into the decode loop, filling a caller-owned batch buffer without
//     holding the Python GIL.
//
// Built with -DMXTT_NO_LIBJPEG where the host has no jpeglib.h: the
// frame parser stays, rio_has_jpeg() returns 0 and the decode entry
// points fail; the iterator then decodes on the card with nvJPEG
// (csrc/jpeg_decode.cu).
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

#ifndef MXTT_NO_LIBJPEG
#include <jpeglib.h>
#endif

namespace {

constexpr uint32_t kMagic = 0xced7230a;

struct Reader {
  FILE* fp = nullptr;
  std::vector<uint8_t> buf;   // assembled logical record
  std::string err;
};

// ---------------------------------------------------------------- frames --

bool read_exact(FILE* fp, void* dst, size_t n) {
  return fread(dst, 1, n, fp) == n;
}

// Returns 1 ok, 0 eof, -1 error. Assembles split records (cflag 1/2/3)
// re-inserting the magic word between parts, mirroring dmlc-core's
// RecordIOReader::NextRecord.
int next_record(Reader* r) {
  r->buf.clear();
  bool in_split = false;
  for (;;) {
    uint32_t magic, lrec;
    if (!read_exact(r->fp, &magic, 4)) return in_split ? -1 : 0;
    if (magic != kMagic) { r->err = "bad magic"; return -1; }
    if (!read_exact(r->fp, &lrec, 4)) { r->err = "truncated"; return -1; }
    uint32_t cflag = lrec >> 29, len = lrec & ((1u << 29) - 1);
    size_t off = r->buf.size();
    if (in_split) {
      const uint8_t* m = reinterpret_cast<const uint8_t*>(&kMagic);
      r->buf.insert(r->buf.end(), m, m + 4);
      off = r->buf.size();
    }
    r->buf.resize(off + len);
    if (len && !read_exact(r->fp, r->buf.data() + off, len)) {
      r->err = "truncated payload"; return -1;
    }
    uint32_t pad = (4 - (len & 3u)) & 3u;
    if (pad) { uint8_t tmp[4]; if (!read_exact(r->fp, tmp, pad)) return -1; }
    if (cflag == 0) return 1;
    if (cflag == 1) { in_split = true; continue; }
    if (cflag == 2) continue;
    if (cflag == 3) return 1;
  }
}

#ifndef MXTT_NO_LIBJPEG
// ------------------------------------------------------------ jpeg decode --

struct JErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jerr_exit(j_common_ptr cinfo) {
  JErr* e = reinterpret_cast<JErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode JPEG to RGB, resize shorter edge to `resize_short` (bilinear,
// 0 = no resize), then crop H×W, optional horizontal mirror. cy/cx: -1 =
// center; else a fraction of the free space in units of 1/10000 (the
// caller can't know post-resize dims, so random crops are expressed
// fractionally). Output HWC uint8 into out (H*W*3). Returns 0 ok.
int decode_one(const uint8_t* data, size_t len, int H, int W,
               int resize_short, int cy, int cx, int mirror,
               uint8_t* out) {
  // buffers are declared BEFORE setjmp: a longjmp from the libjpeg error
  // handler lands back here and we return normally, so their destructors
  // run (declaring them after the setjmp would skip destruction — UB+leak)
  std::vector<uint8_t> img;
  std::vector<uint8_t> resized;
  jpeg_decompress_struct cinfo;
  JErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jerr_exit;
  if (setjmp(jerr.jb)) { jpeg_destroy_decompress(&cinfo); return -1; }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo); return -1;
  }
  cinfo.out_color_space = JCS_RGB;
  // use libjpeg's cheap power-of-2 DCT scaling to get close to the target
  if (resize_short > 0) {
    int short_edge = cinfo.image_height < cinfo.image_width
                         ? cinfo.image_height : cinfo.image_width;
    int denom = 1;
    while (denom < 8 && short_edge / (denom * 2) >= resize_short) denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  int sw = cinfo.output_width, sh = cinfo.output_height;
  img.resize(static_cast<size_t>(sw) * sh * 3);
  JSAMPROW row;
  while (cinfo.output_scanline < cinfo.output_height) {
    row = img.data() + static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // bilinear resize so the short edge == resize_short (or to cover crop)
  int tw = sw, th = sh;
  if (resize_short > 0) {
    if (sh < sw) { th = resize_short; tw = (int)((int64_t)sw * resize_short / sh); }
    else        { tw = resize_short; th = (int)((int64_t)sh * resize_short / sw); }
  }
  if (tw < W) { th = (int)((int64_t)th * W / tw); tw = W; }
  if (th < H) { tw = (int)((int64_t)tw * H / th); th = H; }
  const uint8_t* src = img.data();
  if (tw != sw || th != sh) {
    resized.resize(static_cast<size_t>(tw) * th * 3);
    for (int y = 0; y < th; ++y) {
      float fy = (y + 0.5f) * sh / th - 0.5f;
      int y0 = fy < 0 ? 0 : (int)fy;
      int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
      float wy = fy - y0; if (wy < 0) wy = 0;
      for (int x = 0; x < tw; ++x) {
        float fx = (x + 0.5f) * sw / tw - 0.5f;
        int x0 = fx < 0 ? 0 : (int)fx;
        int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
        float wx = fx - x0; if (wx < 0) wx = 0;
        for (int c = 0; c < 3; ++c) {
          float v00 = img[((size_t)y0 * sw + x0) * 3 + c];
          float v01 = img[((size_t)y0 * sw + x1) * 3 + c];
          float v10 = img[((size_t)y1 * sw + x0) * 3 + c];
          float v11 = img[((size_t)y1 * sw + x1) * 3 + c];
          float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                    v10 * wy * (1 - wx) + v11 * wy * wx;
          resized[((size_t)y * tw + x) * 3 + c] =
              (uint8_t)(v + 0.5f);
        }
      }
    }
    src = resized.data();
    sw = tw; sh = th;
  }
  if (cy < 0) cy = (sh - H) / 2;
  else cy = (int)((int64_t)cy * (sh - H) / 10000);
  if (cx < 0) cx = (sw - W) / 2;
  else cx = (int)((int64_t)cx * (sw - W) / 10000);
  if (cy + H > sh) cy = sh - H;
  if (cx + W > sw) cx = sw - W;
  if (cy < 0 || cx < 0) return -2;  // image smaller than crop
  for (int y = 0; y < H; ++y) {
    const uint8_t* srow = src + (((size_t)(cy + y)) * sw + cx) * 3;
    uint8_t* drow = out + (size_t)y * W * 3;
    if (!mirror) {
      memcpy(drow, srow, (size_t)W * 3);
    } else {
      for (int x = 0; x < W; ++x) {
        const uint8_t* s3 = srow + (size_t)(W - 1 - x) * 3;
        drow[x * 3] = s3[0]; drow[x * 3 + 1] = s3[1]; drow[x * 3 + 2] = s3[2];
      }
    }
  }
  return 0;
}

#endif  // MXTT_NO_LIBJPEG

}  // namespace

extern "C" {

void* rio_open(const char* path) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return nullptr;
  Reader* r = new Reader();
  r->fp = fp;
  return r;
}

void rio_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  if (r) { if (r->fp) fclose(r->fp); delete r; }
}

void rio_seek(void* h, long pos) {
  Reader* r = static_cast<Reader*>(h);
  fseek(r->fp, pos, SEEK_SET);
}

long rio_tell(void* h) {
  Reader* r = static_cast<Reader*>(h);
  return ftell(r->fp);
}

// Returns payload length (>=0) with *out pointing at an internal buffer
// valid until the next call; -1 at EOF; -2 on format error.
long rio_next(void* h, const uint8_t** out) {
  Reader* r = static_cast<Reader*>(h);
  int rc = next_record(r);
  if (rc == 0) return -1;
  if (rc < 0) return -2;
  *out = r->buf.data();
  return static_cast<long>(r->buf.size());
}

int rio_has_jpeg() {
#ifdef MXTT_NO_LIBJPEG
  return 0;
#else
  return 1;
#endif
}

#ifndef MXTT_NO_LIBJPEG
int decode_jpeg(const uint8_t* data, long len, int H, int W,
                int resize_short, int cy, int cx, int mirror, uint8_t* out) {
  return decode_one(data, static_cast<size_t>(len), H, W, resize_short,
                    cy, cx, mirror, out);
}

// Parallel batch decode: n images, offsets[i]/lengths[i] into blob, each
// decoded+cropped into out[i] (H*W*3, HWC uint8). crops: per-image
// (cy, cx, mirror) triples, cy/cx = -1 for center. Returns count of
// failures (failed slots are zero-filled).
int decode_batch(const uint8_t* blob, const int64_t* offsets,
                 const int64_t* lengths, int n, int H, int W,
                 int resize_short, const int32_t* crops, int nthreads,
                 uint8_t* out) {
  if (nthreads < 1) nthreads = 1;
  std::vector<int> fails(nthreads, 0);
  size_t stride = static_cast<size_t>(H) * W * 3;
  auto work = [&](int tid) {
    for (int i = tid; i < n; i += nthreads) {
      uint8_t* dst = out + stride * i;
      int rc = decode_one(blob + offsets[i],
                          static_cast<size_t>(lengths[i]), H, W,
                          resize_short, crops[i * 3], crops[i * 3 + 1],
                          crops[i * 3 + 2], dst);
      if (rc != 0) { memset(dst, 0, stride); fails[tid]++; }
    }
  };
  if (nthreads == 1) {
    work(0);
  } else {
    std::vector<std::thread> ts;
    ts.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) ts.emplace_back(work, t);
    for (auto& t : ts) t.join();
  }
  int total = 0;
  for (int f : fails) total += f;
  return total;
}

#endif  // MXTT_NO_LIBJPEG

}  // extern "C"
