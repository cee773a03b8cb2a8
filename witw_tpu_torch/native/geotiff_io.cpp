// geotiff_io — native windowed GeoTIFF raster I/O + geodesy (witw_tpu_torch's
// copy of witw_tpu/native/geotiff_io.cpp).
//
// The reference's entire dataset pipeline leans on the GDAL C++ library for
// windowed raster reads, tile clipping, CRS transforms and 16->8-bit
// conversion (reference tools/dataset_building/sitetiles.py:10-11,168-171,
// tools/heatmap/heatmap.py:57-66, tools/dataset_building/create_8bit_images.py).
// This is a self-contained replacement: classic TIFF + BigTIFF reader with
// strip/tile organization, none/deflate/LZW compression and horizontal
// predictor; uint8/uint16 samples; GeoTIFF geotransform + EPSG tags; windowed
// reads that touch only the strips/tiles intersecting the window; a uint8
// GeoTIFF writer (deflate); WGS84<->UTM transforms (Karney/Krueger series);
// and separable bilinear/Lanczos3 resampling for warps.
//
// Exposed as a C ABI consumed via ctypes (witw_tpu_torch/tools/geotiff.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// TIFF structures
// ---------------------------------------------------------------------------

namespace {

struct TiffTag {
  uint16_t code;
  uint16_t type;
  uint64_t count;
  std::vector<uint64_t> ivals;
  std::vector<double> dvals;
};

struct TiffFile {
  ~TiffFile() { if (fp) fclose(fp); }
  FILE* fp = nullptr;
  bool big_endian = false;
  bool bigtiff = false;
  uint32_t width = 0, height = 0;
  uint16_t bands = 1;
  uint16_t bits = 8;
  uint16_t compression = 1;      // 1=none, 5=LZW, 8/32946=deflate
  uint16_t predictor = 1;        // 1=none, 2=horizontal differencing
  uint16_t planar = 1;           // 1=chunky
  uint16_t sample_format = 1;    // 1=unsigned int
  // strip or tile organization
  bool tiled = false;
  uint32_t tile_w = 0, tile_h = 0;
  uint32_t rows_per_strip = 0;
  std::vector<uint64_t> chunk_offsets;
  std::vector<uint64_t> chunk_sizes;
  // geo
  double geotransform[6] = {0, 1, 0, 0, 0, -1};
  bool has_geo = false;
  int epsg = 0;
  // decoded-chunk LRU cache
  std::map<uint64_t, std::vector<uint8_t>> cache;
  std::vector<uint64_t> cache_order;
  size_t cache_max = 64;
  // gt_read_window mutates shared state (FILE* position, the LRU cache) and
  // ctypes drops the GIL for the call's duration — concurrent reads on one
  // handle must serialize or an interleaved fseek/fread decodes wrong bytes
  // (and the cache map races).
  std::mutex mu;
};

uint64_t rd_uint(FILE* fp, int nbytes, bool be) {
  uint8_t buf[8] = {0};
  if (fread(buf, 1, nbytes, fp) != (size_t)nbytes) return 0;
  uint64_t v = 0;
  if (be) {
    for (int i = 0; i < nbytes; i++) v = (v << 8) | buf[i];
  } else {
    for (int i = nbytes - 1; i >= 0; i--) v = (v << 8) | buf[i];
  }
  return v;
}

double type_size(uint16_t type) {
  switch (type) {
    case 1: case 2: case 6: case 7: return 1;   // BYTE/ASCII/SBYTE/UNDEF
    case 3: case 8: return 2;                    // SHORT
    case 4: case 9: case 11: return 4;           // LONG/FLOAT
    case 5: case 10: case 12: return 8;          // RATIONAL/DOUBLE
    case 16: case 17: return 8;                  // LONG8 (BigTIFF)
    default: return 1;
  }
}

double rd_double_at(const uint8_t* p, uint16_t type, bool be) {
  auto load = [&](int n) {
    uint64_t v = 0;
    if (be) { for (int i = 0; i < n; i++) v = (v << 8) | p[i]; }
    else { for (int i = n - 1; i >= 0; i--) v = (v << 8) | p[i]; }
    return v;
  };
  switch (type) {
    case 1: case 2: case 6: case 7: return (double)p[0];
    case 3: return (double)load(2);
    case 4: return (double)load(4);
    case 16: return (double)load(8);
    case 11: { uint32_t v = (uint32_t)load(4); float f; memcpy(&f, &v, 4); return f; }
    case 12: { uint64_t v = load(8); double d; memcpy(&d, &v, 8); return d; }
    case 5: { uint32_t n = (uint32_t)load(4); uint32_t d = 0;
              if (be) { for (int i = 4; i < 8; i++) d = (d << 8) | p[i]; }
              else { for (int i = 7; i >= 4; i--) d = (d << 8) | p[i]; }
              return d ? (double)n / d : 0; }
    default: return (double)load((int)type_size(type));
  }
}

// Hard caps against attacker-sized allocations from corrupt/malicious files:
// tag value arrays and decoded chunks are bounded well above any real GeoTIFF
// this pipeline handles, far below anything that could exhaust memory.
constexpr uint64_t kMaxTagBytes = 1ull << 28;    // 256 MB of tag values
constexpr uint64_t kMaxChunkBytes = 1ull << 31;  // 2 GB decoded chunk

bool read_tag_values(TiffFile* t, TiffTag& tag, uint64_t value_or_offset_pos) {
  int inline_bytes = t->bigtiff ? 8 : 4;
  if (tag.count == 0) return false;  // truncated/corrupt entry: [0] would be OOB
  uint64_t esz64 = (uint64_t)type_size(tag.type);
  if (tag.count > kMaxTagBytes / std::max<uint64_t>(esz64, 1)) return false;
  uint64_t total = tag.count * esz64;
  std::vector<uint8_t> raw(std::max<uint64_t>(total, 1));
  if (total <= (uint64_t)inline_bytes) {
    long save = ftell(t->fp);
    fseek(t->fp, (long)value_or_offset_pos, SEEK_SET);
    if (fread(raw.data(), 1, total, t->fp) != total) return false;
    fseek(t->fp, save, SEEK_SET);
  } else {
    long save = ftell(t->fp);
    fseek(t->fp, (long)value_or_offset_pos, SEEK_SET);
    uint64_t off = rd_uint(t->fp, inline_bytes, t->big_endian);
    fseek(t->fp, (long)off, SEEK_SET);
    if (fread(raw.data(), 1, total, t->fp) != total) return false;
    fseek(t->fp, save, SEEK_SET);
  }
  size_t esz = (size_t)type_size(tag.type);
  for (uint64_t i = 0; i < tag.count; i++) {
    double d = rd_double_at(raw.data() + i * esz, tag.type, t->big_endian);
    tag.dvals.push_back(d);
    tag.ivals.push_back((uint64_t)d);
  }
  return true;
}

// --- LZW decompression (TIFF variant, MSB-first codes) ---
// max_out bounds dst growth; a stream that overruns the 4096-entry table,
// references an undefined code, or emits past max_out is treated as corrupt.
bool lzw_decode(const uint8_t* src, size_t srclen, std::vector<uint8_t>& dst,
                size_t max_out) {
  struct Entry { int prev; uint8_t ch; uint16_t len; };
  std::vector<Entry> table(4096);
  auto reset = [&](int& next, int& bits) {
    for (int i = 0; i < 256; i++) table[i] = {-1, (uint8_t)i, 1};
    next = 258; bits = 9;
  };
  int next_code, code_bits;
  reset(next_code, code_bits);
  uint32_t bitbuf = 0; int bitcnt = 0; size_t pos = 0;
  int prev_code = -1;
  auto emit = [&](int code) {
    // write the string for `code` (reversed chain)
    size_t start = dst.size();
    if (start + table[code].len > max_out) return false;
    dst.resize(start + table[code].len);
    int c = code;
    for (int i = table[code].len - 1; i >= 0; i--) { dst[start + i] = table[c].ch; c = table[c].prev; }
    return true;
  };
  while (true) {
    while (bitcnt < code_bits && pos < srclen) { bitbuf = (bitbuf << 8) | src[pos++]; bitcnt += 8; }
    if (bitcnt < code_bits) break;
    int code = (int)((bitbuf >> (bitcnt - code_bits)) & ((1u << code_bits) - 1));
    bitcnt -= code_bits;
    if (code == 256) { reset(next_code, code_bits); prev_code = -1; continue; }
    if (code == 257) break;  // EOI
    if (code > next_code) return false;  // references an undefined entry
    if (prev_code < 0) {
      if (code >= 256) return false;  // first code after reset must be a literal
      if (!emit(code)) return false;
      prev_code = code;
      continue;
    }
    // A conforming encoder emits a clear code before the table fills; a
    // stream that would write entry 4096 is corrupt (heap-OOB otherwise).
    if (next_code >= 4096) return false;
    if (code < next_code) {
      if (!emit(code)) return false;
      // add prev + first char of code
      int c = code; while (table[c].prev >= 0) c = table[c].prev;
      table[next_code] = {prev_code, table[c].ch, (uint16_t)(table[prev_code].len + 1)};
    } else {
      // code == next_code: prev + first char of prev
      int c = prev_code; while (table[c].prev >= 0) c = table[c].prev;
      table[next_code] = {prev_code, table[c].ch, (uint16_t)(table[prev_code].len + 1)};
      if (!emit(next_code)) return false;
    }
    next_code++;
    if (next_code == (1 << code_bits) - 1 && code_bits < 12) code_bits++;
    prev_code = code;
  }
  return true;
}

bool inflate_buf(const uint8_t* src, size_t srclen, std::vector<uint8_t>& dst, size_t expect) {
  dst.resize(expect);
  uLongf dlen = (uLongf)expect;
  int rc = uncompress(dst.data(), &dlen, src, (uLong)srclen);
  if (rc != Z_OK) return false;
  dst.resize(dlen);
  return true;
}

// Decode chunk `idx` (strip or tile) into cache; returns decoded bytes.
const std::vector<uint8_t>* get_chunk(TiffFile* t, uint64_t idx) {
  auto it = t->cache.find(idx);
  if (it != t->cache.end()) return &it->second;
  if (idx >= t->chunk_offsets.size()) return nullptr;

  size_t bytes_per_sample = t->bits / 8;
  uint64_t chunk_w = t->tiled ? t->tile_w : t->width;
  uint64_t chunk_h;
  if (t->tiled) {
    chunk_h = t->tile_h;
  } else {
    uint64_t row0 = idx * t->rows_per_strip;
    if (row0 >= t->height) return nullptr;
    chunk_h = std::min<uint64_t>(t->rows_per_strip, t->height - row0);
  }
  // Overflow-safe product check against the decoded-chunk cap.
  uint64_t px = chunk_w * chunk_h;
  if (chunk_w != 0 && px / chunk_w != chunk_h) return nullptr;
  uint64_t samples = px * t->bands;
  if (px != 0 && samples / px != t->bands) return nullptr;
  uint64_t raw_size = samples * bytes_per_sample;
  if (raw_size == 0 || raw_size > kMaxChunkBytes) return nullptr;
  if (idx >= t->chunk_sizes.size() || t->chunk_sizes[idx] > kMaxChunkBytes) return nullptr;

  std::vector<uint8_t> comp(t->chunk_sizes[idx]);
  fseek(t->fp, (long)t->chunk_offsets[idx], SEEK_SET);
  if (fread(comp.data(), 1, comp.size(), t->fp) != comp.size()) return nullptr;

  std::vector<uint8_t> out;
  if (t->compression == 1) {
    out = std::move(comp);
    out.resize(raw_size);
  } else if (t->compression == 8 || t->compression == 32946) {
    if (!inflate_buf(comp.data(), comp.size(), out, raw_size)) return nullptr;
  } else if (t->compression == 5) {
    out.reserve(raw_size);
    if (!lzw_decode(comp.data(), comp.size(), out, raw_size)) return nullptr;
    out.resize(raw_size);
  } else {
    return nullptr;  // unsupported compression
  }

  // Endian swap BEFORE the predictor: TIFF predictor differences apply to
  // the sample VALUES, so 16-bit accumulation must run on native-order
  // values — adding the byte-swapped halves first carries in the wrong byte
  // (BE 0x00FF + diff 0x0001 must give 0x0100, not 0x0000).
  if (bytes_per_sample == 2 && t->big_endian) {
    for (size_t i = 0; i + 1 < out.size(); i += 2) std::swap(out[i], out[i + 1]);
  }

  // horizontal predictor
  if (t->predictor == 2) {
    size_t row_bytes = chunk_w * t->bands * bytes_per_sample;
    for (uint64_t r = 0; r < chunk_h; r++) {
      uint8_t* row = out.data() + r * row_bytes;
      if (bytes_per_sample == 1) {
        for (uint64_t i = t->bands; i < chunk_w * t->bands; i++) row[i] = (uint8_t)(row[i] + row[i - t->bands]);
      } else {
        uint16_t* row16 = (uint16_t*)row;
        for (uint64_t i = t->bands; i < chunk_w * t->bands; i++) row16[i] = (uint16_t)(row16[i] + row16[i - t->bands]);
      }
    }
  }

  if (t->cache.size() >= t->cache_max && !t->cache_order.empty()) {
    t->cache.erase(t->cache_order.front());
    t->cache_order.erase(t->cache_order.begin());
  }
  t->cache_order.push_back(idx);
  auto res = t->cache.emplace(idx, std::move(out));
  return &res.first->second;
}

void parse_geokeys(TiffFile* t, const TiffTag& tag) {
  // GeoKeyDirectory: header (4 shorts) then 4-short entries.
  const auto& v = tag.ivals;
  if (v.size() < 4) return;
  uint64_t nkeys = v[3];
  for (uint64_t k = 0; k < nkeys && 4 + 4 * k + 3 < v.size(); k++) {
    uint64_t key = v[4 + 4 * k];
    uint64_t loc = v[4 + 4 * k + 1];
    uint64_t val = v[4 + 4 * k + 3];
    if ((key == 3072 || key == 2048) && loc == 0) {  // ProjectedCSType / GeographicType
      if (t->epsg == 0 || key == 3072) t->epsg = (int)val;
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C API: open/read/close
// ---------------------------------------------------------------------------

// All extern-C entry points catch C++ exceptions (bad_alloc from corrupt
// sizes, etc.) — nothing may unwind across the ctypes ABI boundary.
void* gt_open(const char* path) try {
  std::unique_ptr<TiffFile> t(new TiffFile());
  t->fp = fopen(path, "rb");
  if (!t->fp) return nullptr;
  uint8_t hdr[4];
  if (fread(hdr, 1, 4, t->fp) != 4) return nullptr;
  if (hdr[0] == 'M' && hdr[1] == 'M') t->big_endian = true;
  else if (hdr[0] != 'I' || hdr[1] != 'I') return nullptr;
  uint16_t magic = t->big_endian ? (hdr[2] << 8 | hdr[3]) : (hdr[3] << 8 | hdr[2]);
  uint64_t ifd_off;
  if (magic == 42) {
    t->bigtiff = false;
    ifd_off = rd_uint(t->fp, 4, t->big_endian);
  } else if (magic == 43) {
    t->bigtiff = true;
    rd_uint(t->fp, 2, t->big_endian);  // offset size (8)
    rd_uint(t->fp, 2, t->big_endian);  // reserved
    ifd_off = rd_uint(t->fp, 8, t->big_endian);
  } else {
    return nullptr;
  }

  fseek(t->fp, (long)ifd_off, SEEK_SET);
  uint64_t ntags = rd_uint(t->fp, t->bigtiff ? 8 : 2, t->big_endian);
  int entry_size = t->bigtiff ? 20 : 12;
  uint64_t entries_start = (uint64_t)ftell(t->fp);

  std::vector<double> pixel_scale, tiepoint, geo_doubles;
  std::vector<uint64_t> bits_per_sample;
  for (uint64_t i = 0; i < ntags; i++) {
    uint64_t pos = entries_start + i * entry_size;
    fseek(t->fp, (long)pos, SEEK_SET);
    TiffTag tag;
    tag.code = (uint16_t)rd_uint(t->fp, 2, t->big_endian);
    tag.type = (uint16_t)rd_uint(t->fp, 2, t->big_endian);
    tag.count = rd_uint(t->fp, t->bigtiff ? 8 : 4, t->big_endian);
    uint64_t val_pos = pos + (t->bigtiff ? 12 : 8);
    switch (tag.code) {
      case 256: case 257: case 258: case 259: case 277: case 278:
      case 284: case 317: case 322: case 323: case 339:
      case 273: case 279: case 324: case 325:
      case 33550: case 33922: case 34735: case 34736:
        if (!read_tag_values(t.get(), tag, val_pos)) continue;
        break;
      default:
        continue;
    }
    switch (tag.code) {
      case 256: t->width = (uint32_t)tag.ivals[0]; break;
      case 257: t->height = (uint32_t)tag.ivals[0]; break;
      case 258: bits_per_sample = tag.ivals; break;
      case 259: t->compression = (uint16_t)tag.ivals[0]; break;
      case 277: t->bands = (uint16_t)tag.ivals[0]; break;
      case 278: t->rows_per_strip = (uint32_t)tag.ivals[0]; break;
      case 284: t->planar = (uint16_t)tag.ivals[0]; break;
      case 317: t->predictor = (uint16_t)tag.ivals[0]; break;
      case 322: t->tile_w = (uint32_t)tag.ivals[0]; break;
      case 323: t->tile_h = (uint32_t)tag.ivals[0]; break;
      case 339: t->sample_format = (uint16_t)tag.ivals[0]; break;
      case 273: case 324: t->chunk_offsets = tag.ivals; if (tag.code == 324) t->tiled = true; break;
      case 279: case 325: t->chunk_sizes = tag.ivals; break;
      case 33550: pixel_scale = tag.dvals; break;
      case 33922: tiepoint = tag.dvals; break;
      case 34735: parse_geokeys(t.get(), tag); break;
      case 34736: geo_doubles = tag.dvals; break;
    }
  }
  if (!bits_per_sample.empty()) t->bits = (uint16_t)bits_per_sample[0];
  if (t->tile_w > 0 && !t->chunk_offsets.empty()) t->tiled = true;
  if (!t->tiled && t->rows_per_strip == 0) t->rows_per_strip = t->height;
  if (t->width == 0 || t->height == 0) return nullptr;
  if (t->bits != 8 && t->bits != 16) return nullptr;
  if (t->planar != 1) return nullptr;
  if (t->bands == 0) return nullptr;
  if (t->tiled && (t->tile_w == 0 || t->tile_h == 0)) return nullptr;
  if (t->chunk_offsets.size() != t->chunk_sizes.size()) return nullptr;
  if (t->chunk_offsets.empty()) return nullptr;

  if (pixel_scale.size() >= 2 && tiepoint.size() >= 6) {
    // geotransform: x = x0 + px*sx ; y = y0 - py*sy
    t->geotransform[0] = tiepoint[3] - tiepoint[0] * pixel_scale[0];
    t->geotransform[1] = pixel_scale[0];
    t->geotransform[2] = 0;
    t->geotransform[3] = tiepoint[4] + tiepoint[1] * pixel_scale[1];
    t->geotransform[4] = 0;
    t->geotransform[5] = -pixel_scale[1];
    t->has_geo = true;
  }
  return t.release();
} catch (...) {
  return nullptr;
}

void gt_close(void* h) {
  delete (TiffFile*)h;  // destructor closes fp
}

long gt_width(void* h) { return ((TiffFile*)h)->width; }
long gt_height(void* h) { return ((TiffFile*)h)->height; }
int gt_bands(void* h) { return ((TiffFile*)h)->bands; }
int gt_bits(void* h) { return ((TiffFile*)h)->bits; }
int gt_epsg(void* h) { return ((TiffFile*)h)->epsg; }
int gt_has_geo(void* h) { return ((TiffFile*)h)->has_geo ? 1 : 0; }

int gt_geotransform(void* h, double* gt6) {
  TiffFile* t = (TiffFile*)h;
  memcpy(gt6, t->geotransform, 6 * sizeof(double));
  return t->has_geo ? 0 : 1;
}

// Windowed read into dst as uint16 HWC (caller converts); out-of-bounds = 0.
int gt_read_window(void* h, long x0, long y0, long w, long hgt, uint16_t* dst) try {
  TiffFile* t = (TiffFile*)h;
  std::lock_guard<std::mutex> lock(t->mu);
  size_t bps = t->bits / 8;
  memset(dst, 0, (size_t)w * hgt * t->bands * sizeof(uint16_t));

  long rx0 = std::max(0L, x0), ry0 = std::max(0L, y0);
  long rx1 = std::min((long)t->width, x0 + w), ry1 = std::min((long)t->height, y0 + hgt);
  if (rx0 >= rx1 || ry0 >= ry1) return 0;

  if (!t->tiled) {
    for (long y = ry0; y < ry1; y++) {
      uint64_t strip = y / t->rows_per_strip;
      const std::vector<uint8_t>* chunk = get_chunk(t, strip);
      if (!chunk) return 1;
      long row_in = y - strip * t->rows_per_strip;
      const uint8_t* src = chunk->data() + (size_t)row_in * t->width * t->bands * bps;
      uint16_t* drow = dst + ((size_t)(y - y0) * w + (rx0 - x0)) * t->bands;
      if (bps == 1) {
        const uint8_t* s = src + (size_t)rx0 * t->bands;
        for (long i = 0; i < (rx1 - rx0) * t->bands; i++) drow[i] = s[i];
      } else {
        const uint16_t* s = (const uint16_t*)src + (size_t)rx0 * t->bands;
        memcpy(drow, s, (size_t)(rx1 - rx0) * t->bands * 2);
      }
    }
  } else {
    long tx0 = rx0 / t->tile_w, tx1 = (rx1 - 1) / t->tile_w;
    long ty0 = ry0 / t->tile_h, ty1 = (ry1 - 1) / t->tile_h;
    uint64_t tiles_across = (t->width + t->tile_w - 1) / t->tile_w;
    for (long ty = ty0; ty <= ty1; ty++) {
      for (long tx = tx0; tx <= tx1; tx++) {
        const std::vector<uint8_t>* chunk = get_chunk(t, (uint64_t)ty * tiles_across + tx);
        if (!chunk) return 1;
        long cx0 = std::max(rx0, tx * (long)t->tile_w);
        long cx1 = std::min(rx1, (tx + 1) * (long)t->tile_w);
        long cy0 = std::max(ry0, ty * (long)t->tile_h);
        long cy1 = std::min(ry1, (ty + 1) * (long)t->tile_h);
        for (long y = cy0; y < cy1; y++) {
          const uint8_t* src = chunk->data() +
              (((size_t)(y - ty * t->tile_h) * t->tile_w + (cx0 - tx * t->tile_w)) * t->bands) * bps;
          uint16_t* drow = dst + ((size_t)(y - y0) * w + (cx0 - x0)) * t->bands;
          if (bps == 1) {
            for (long i = 0; i < (cx1 - cx0) * t->bands; i++) drow[i] = src[i];
          } else {
            memcpy(drow, src, (size_t)(cx1 - cx0) * t->bands * 2);
          }
        }
      }
    }
  }
  return 0;
} catch (...) {
  return 1;
}

// ---------------------------------------------------------------------------
// uint8 GeoTIFF writer (stripped, deflate or none)
// ---------------------------------------------------------------------------

namespace {
void wr(FILE* fp, uint64_t v, int nbytes) {
  for (int i = 0; i < nbytes; i++) fputc((int)((v >> (8 * i)) & 0xff), fp);
}
struct WTag { uint16_t code, type; uint32_t count; uint64_t value; };
}  // namespace

int gt_write_u8(const char* path, const uint8_t* data, long w, long h, int bands,
                const double* gt6, int epsg, int compress) try {
  // A degenerate raster would make nstrips 0 and strip_offsets[0] below an
  // OOB read on an empty vector; fail cleanly instead.
  if (w <= 0 || h <= 0 || bands <= 0) return 4;
  // RAII so the handle closes on the exception path too (the catch-all
  // below would otherwise leak the FILE on e.g. bad_alloc).
  std::unique_ptr<FILE, int (*)(FILE*)> fp_guard(fopen(path, "wb"), fclose);
  FILE* fp = fp_guard.get();
  if (!fp) return 1;

  // compress rows-per-strip blocks
  uint32_t rps = std::max(1L, std::min((long)h, (long)(1 << 20) / std::max(1L, w * bands)));
  uint32_t nstrips = (h + rps - 1) / rps;
  std::vector<std::vector<uint8_t>> strips(nstrips);
  for (uint32_t s = 0; s < nstrips; s++) {
    long y0 = s * rps;
    long rows = std::min((long)rps, h - y0);
    const uint8_t* src = data + (size_t)y0 * w * bands;
    size_t raw = (size_t)rows * w * bands;
    if (compress) {
      uLongf clen = compressBound((uLong)raw);
      strips[s].resize(clen);
      if (compress2(strips[s].data(), &clen, src, (uLong)raw, 6) != Z_OK) return 2;  // fp_guard closes fp
      strips[s].resize(clen);
    } else {
      strips[s].assign(src, src + raw);
    }
  }

  bool has_geo = gt6 != nullptr;
  double pixel_scale[3] = {has_geo ? gt6[1] : 1.0, has_geo ? -gt6[5] : 1.0, 0.0};
  double tiepoint[6] = {0, 0, 0, has_geo ? gt6[0] : 0.0, has_geo ? gt6[3] : 0.0, 0};
  uint16_t geokeys[] = {
      1, 1, 0, 3,
      1024, 0, 1, 1,                       // GTModelType = projected
      1025, 0, 1, 1,                       // RasterPixelIsArea
      3072, 0, 1, (uint16_t)epsg,          // ProjectedCSType
  };

  // layout: header(8) | IFD | external arrays | strip data
  std::vector<WTag> tags;
  uint16_t ntags_fixed = has_geo ? 16 : 13;
  uint32_t ifd_off = 8;
  uint32_t ifd_size = 2 + ntags_fixed * 12 + 4;
  uint32_t ext = ifd_off + ifd_size;

  uint32_t bps_off = ext; ext += bands > 2 ? bands * 2 : 0;
  uint32_t strip_off_arr = ext; ext += nstrips > 1 ? nstrips * 4 : 0;
  uint32_t strip_cnt_arr = ext; ext += nstrips > 1 ? nstrips * 4 : 0;
  uint32_t ps_off = ext; ext += has_geo ? 3 * 8 : 0;
  uint32_t tp_off = ext; ext += has_geo ? 6 * 8 : 0;
  uint32_t gk_off = ext; ext += has_geo ? (uint32_t)sizeof(geokeys) : 0;
  uint32_t data_off = ext;

  std::vector<uint64_t> strip_offsets(nstrips), strip_counts(nstrips);
  uint64_t cur = data_off;
  for (uint32_t s = 0; s < nstrips; s++) {
    strip_offsets[s] = cur;
    strip_counts[s] = strips[s].size();
    cur += strips[s].size();
  }
  // Classic TIFF carries 32-bit offsets: a >4 GB output would silently
  // truncate strip offsets (corrupt file, rc 0). Fail cleanly; BigTIFF
  // output is out of scope for the 8-bit tile/strip writer.
  if (cur > 0xFFFFFFFFull) return 5;

  uint16_t bps_val = 8;
  tags.push_back({254, 4, 1, 0});  // NewSubfileType
  tags.push_back({256, 4, 1, (uint64_t)w});
  tags.push_back({257, 4, 1, (uint64_t)h});
  if (bands > 2) tags.push_back({258, 3, (uint32_t)bands, bps_off});
  else tags.push_back({258, 3, 1, bps_val});
  tags.push_back({259, 3, 1, compress ? 8u : 1u});
  tags.push_back({262, 3, 1, bands >= 3 ? 2u : 1u});  // RGB or grayscale
  tags.push_back({273, 4, nstrips, nstrips > 1 ? strip_off_arr : strip_offsets[0]});
  tags.push_back({277, 3, 1, (uint64_t)bands});
  tags.push_back({278, 4, 1, rps});
  tags.push_back({279, 4, nstrips, nstrips > 1 ? strip_cnt_arr : strip_counts[0]});
  tags.push_back({284, 3, 1, 1});
  tags.push_back({296, 3, 1, 1});  // ResolutionUnit = none
  tags.push_back({339, 3, 1, 1});
  if (has_geo) {
    tags.push_back({33550, 12, 3, ps_off});
    tags.push_back({33922, 12, 6, tp_off});
    tags.push_back({34735, 3, (uint32_t)(sizeof(geokeys) / 2), gk_off});
  }

  std::sort(tags.begin(), tags.end(), [](const WTag& a, const WTag& b) { return a.code < b.code; });

  // header
  fputc('I', fp); fputc('I', fp); wr(fp, 42, 2); wr(fp, ifd_off, 4);
  // IFD
  wr(fp, tags.size(), 2);
  for (auto& tg : tags) {
    wr(fp, tg.code, 2); wr(fp, tg.type, 2); wr(fp, tg.count, 4);
    uint64_t v = tg.value;
    // inline SHORT values occupy low bytes
    wr(fp, v, 4);
  }
  wr(fp, 0, 4);  // next IFD
  // external arrays
  if (bands > 2) for (int b = 0; b < bands; b++) wr(fp, 8, 2);
  if (nstrips > 1) { for (auto v : strip_offsets) wr(fp, v, 4); for (auto v : strip_counts) wr(fp, v, 4); }
  if (has_geo) {
    auto wrd = [&](double d) { uint64_t v; memcpy(&v, &d, 8); wr(fp, v, 8); };
    for (double d : pixel_scale) wrd(d);
    for (double d : tiepoint) wrd(d);
    for (uint16_t g : geokeys) wr(fp, g, 2);
  }
  for (uint32_t s = 0; s < nstrips; s++) fwrite(strips[s].data(), 1, strips[s].size(), fp);
  return 0;
} catch (...) {
  return 3;
}

// ---------------------------------------------------------------------------
// Geodesy: WGS84 <-> UTM (Krueger series, ~0.1 mm accuracy)
// ---------------------------------------------------------------------------

namespace {
constexpr double kA = 6378137.0;
constexpr double kF = 1.0 / 298.257223563;
constexpr double kK0 = 0.9996;
constexpr double kE0 = 500000.0;
const double kN = kF / (2 - kF);
}  // namespace

void geo_wgs84_to_utm(double lat, double lon, int zone, int north, double* e_out, double* n_out) {
  double lat_r = lat * M_PI / 180.0;
  double lon0 = (zone * 6.0 - 183.0) * M_PI / 180.0;
  double lon_r = lon * M_PI / 180.0 - lon0;

  double n = kN;
  double n2 = n * n, n3 = n2 * n;
  double t = sinh(atanh(sin(lat_r)) - 2 * sqrt(n) / (1 + n) * atanh(2 * sqrt(n) / (1 + n) * sin(lat_r)));
  double xi = atan2(t, cos(lon_r));
  double eta = atanh(sin(lon_r) / sqrt(1 + t * t));

  double A = kA / (1 + n) * (1 + n2 / 4 + n2 * n2 / 64);
  double alpha[4] = {0,
      n / 2 - 2 * n2 / 3 + 5 * n3 / 16,
      13 * n2 / 48 - 3 * n3 / 5,
      61 * n3 / 240};

  double xi_s = xi, eta_s = eta;
  for (int j = 1; j <= 3; j++) {
    xi_s += alpha[j] * sin(2 * j * xi) * cosh(2 * j * eta);
    eta_s += alpha[j] * cos(2 * j * xi) * sinh(2 * j * eta);
  }
  double easting = kE0 + kK0 * A * eta_s;
  double northing = kK0 * A * xi_s;
  if (!north) northing += 10000000.0;
  *e_out = easting;
  *n_out = northing;
}

void geo_utm_to_wgs84(double easting, double northing, int zone, int north,
                      double* lat_out, double* lon_out) {
  double n = kN;
  double n2 = n * n, n3 = n2 * n;
  double A = kA / (1 + n) * (1 + n2 / 4 + n2 * n2 / 64);
  double y = north ? northing : northing - 10000000.0;
  double xi = y / (kK0 * A);
  double eta = (easting - kE0) / (kK0 * A);

  double beta[4] = {0,
      n / 2 - 2 * n2 / 3 + 37 * n3 / 96,
      n2 / 48 + n3 / 15,
      17 * n3 / 480};
  double xi_p = xi, eta_p = eta;
  for (int j = 1; j <= 3; j++) {
    xi_p -= beta[j] * sin(2 * j * xi) * cosh(2 * j * eta);
    eta_p -= beta[j] * cos(2 * j * xi) * sinh(2 * j * eta);
  }
  double chi = asin(sin(xi_p) / cosh(eta_p));
  double lat = chi;
  double delta[4] = {0,
      2 * n - 2 * n2 / 3 - 2 * n3,
      7 * n2 / 3 - 8 * n3 / 5,
      56 * n3 / 15};
  for (int j = 1; j <= 3; j++) lat += delta[j] * sin(2 * j * chi);

  double lon0 = zone * 6.0 - 183.0;
  *lat_out = lat * 180.0 / M_PI;
  *lon_out = lon0 + atan2(sinh(eta_p), cos(xi_p)) * 180.0 / M_PI;
}

int geo_utm_zone(double lon) { return (int)((lon + 180.0) / 6.0) + 1; }

int geo_utm_epsg(double lat, double lon) {
  int zone = geo_utm_zone(lon);
  return (lat >= 0 ? 32600 : 32700) + zone;
}

// ---------------------------------------------------------------------------
// Resampling: bilinear / Lanczos3, separable, float32 HWC
// ---------------------------------------------------------------------------

namespace {
double lanczos3(double x) {
  if (x == 0) return 1.0;
  if (x <= -3.0 || x >= 3.0) return 0.0;
  double px = M_PI * x;
  return 3.0 * sin(px) * sin(px / 3.0) / (px * px);
}
}  // namespace

// method: 0 = bilinear, 1 = lanczos3. Half-pixel-center convention.
int gt_resample(const float* src, long sw, long sh, int bands,
                float* dst, long dw, long dh, int method) try {
  double sx = (double)sw / dw, sy = (double)sh / dh;
  std::vector<float> tmp((size_t)sh * dw * bands);

  auto resample_line = [&](const float* in, long in_len, long in_stride,
                           float* out, long out_len, long out_stride, double scale) {
    double support = method == 1 ? 3.0 * std::max(1.0, scale) : std::max(1.0, scale);
    for (long o = 0; o < out_len; o++) {
      double center = (o + 0.5) * scale - 0.5;
      long lo = (long)floor(center - support);
      long hi = (long)ceil(center + support);
      double wsum = 0;
      std::vector<double> acc(bands, 0.0);
      for (long i = lo; i <= hi; i++) {
        double d = (center - i) / (method == 1 ? std::max(1.0, scale) : 1.0);
        double wgt;
        if (method == 1) wgt = lanczos3(d);
        else {
          double ad = fabs(center - i) / std::max(1.0, scale);
          wgt = ad < 1.0 ? 1.0 - ad : 0.0;
        }
        if (wgt == 0) continue;
        long ii = std::min(std::max(i, 0L), in_len - 1);
        for (int b = 0; b < bands; b++) acc[b] += wgt * in[ii * in_stride + b];
        wsum += wgt;
      }
      for (int b = 0; b < bands; b++) out[o * out_stride + b] = (float)(wsum > 0 ? acc[b] / wsum : 0);
    }
  };

  // horizontal pass
  for (long y = 0; y < sh; y++)
    resample_line(src + (size_t)y * sw * bands, sw, bands,
                  tmp.data() + (size_t)y * dw * bands, dw, bands, sx);
  // vertical pass
  for (long x = 0; x < dw; x++)
    resample_line(tmp.data() + (size_t)x * bands, sh, (long)dw * bands,
                  dst + (size_t)x * bands, dh, (long)dw * bands, sy);
  return 0;
} catch (...) {
  return 1;
}

}  // extern "C"
