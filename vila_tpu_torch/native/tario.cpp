// tario: indexed random access into tar shards (webdataset-style).
//
// Capability parity: the reference's vendored `wids` indexed tar sampling
// (llava/wids/wids.py:226 `IndexedTarSamples`, llava/wids/wids_mmtar.py) —
// random access to members of a tar shard without streaming the whole file.
//
// Design (native, zero-copy): mmap the shard once, parse ustar/pax headers
// into an in-memory index of (name, offset, size), and serve reads as
// pointers into the mapping. Exposed as a tiny C ABI consumed from Python
// via ctypes (no pybind11 dependency).
//
// The port's copy of native/tario.cpp. vila_tpu_torch/data/tario.py builds
// it at first use with g++ -O2 -shared -fPIC into vila_tpu_torch/_build/
// (libtario_<hash of this file>.so).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Entry {
  std::string name;
  uint64_t offset;  // offset of file data within the shard
  uint64_t size;
};

struct Shard {
  int fd = -1;
  const uint8_t* map = nullptr;
  uint64_t map_len = 0;
  std::vector<Entry> entries;
};

uint64_t parse_octal(const char* p, size_t n) {
  uint64_t v = 0;
  for (size_t i = 0; i < n && p[i]; ++i) {
    if (p[i] < '0' || p[i] > '7') continue;
    v = (v << 3) | uint64_t(p[i] - '0');
  }
  return v;
}

// GNU/star base-256 size encoding (first byte has high bit set).
uint64_t parse_size(const char* p, size_t n) {
  if (uint8_t(p[0]) & 0x80) {
    uint64_t v = uint64_t(uint8_t(p[0]) & 0x7f);
    for (size_t i = 1; i < n; ++i) v = (v << 8) | uint8_t(p[i]);
    return v;
  }
  return parse_octal(p, n);
}

bool is_zero_block(const uint8_t* b) {
  for (int i = 0; i < 512; ++i)
    if (b[i]) return false;
  return true;
}

// Parse the tar at map[0..len) into entries (regular files only).
void build_index(Shard* s) {
  uint64_t off = 0;
  std::string pending_longname;
  while (off + 512 <= s->map_len) {
    const uint8_t* hdr = s->map + off;
    if (is_zero_block(hdr)) break;  // end-of-archive
    const char* h = reinterpret_cast<const char*>(hdr);
    uint64_t size = parse_size(h + 124, 12);
    char typeflag = h[156];
    uint64_t data_off = off + 512;
    uint64_t padded = (size + 511) & ~uint64_t(511);

    if (typeflag == 'L') {
      // GNU longname: data block holds the next entry's name
      pending_longname.assign(h + 512, strnlen(h + 512, size));
    } else if (typeflag == 'x' || typeflag == 'g') {
      // pax headers: scan for "path=" record
      std::string block(h + 512, size);
      size_t pos = 0;
      while (pos < block.size()) {
        size_t sp = block.find(' ', pos);
        if (sp == std::string::npos) break;
        size_t reclen = strtoull(block.c_str() + pos, nullptr, 10);
        if (reclen == 0) break;
        std::string rec = block.substr(sp + 1, reclen - (sp - pos) - 2);
        if (rec.rfind("path=", 0) == 0) pending_longname = rec.substr(5);
        pos += reclen;
      }
    } else if (typeflag == '0' || typeflag == '\0') {
      Entry e;
      if (!pending_longname.empty()) {
        e.name = pending_longname;
        pending_longname.clear();
      } else {
        char name[257];
        // ustar prefix + name
        char prefix[156];
        memcpy(prefix, h + 345, 155);
        prefix[155] = 0;
        char base[101];
        memcpy(base, h, 100);
        base[100] = 0;
        if (memcmp(h + 257, "ustar", 5) == 0 && prefix[0]) {
          snprintf(name, sizeof(name), "%s/%s", prefix, base);
        } else {
          snprintf(name, sizeof(name), "%s", base);
        }
        e.name = name;
      }
      e.offset = data_off;
      e.size = size;
      s->entries.push_back(std::move(e));
    } else {
      pending_longname.clear();
    }
    off = data_off + padded;
  }
}

}  // namespace

extern "C" {

void* tario_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 512) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(map, st.st_size, MADV_RANDOM);
  auto* s = new Shard();
  s->fd = fd;
  s->map = static_cast<const uint8_t*>(map);
  s->map_len = st.st_size;
  build_index(s);
  return s;
}

void tario_close(void* handle) {
  auto* s = static_cast<Shard*>(handle);
  if (!s) return;
  if (s->map) munmap(const_cast<uint8_t*>(s->map), s->map_len);
  if (s->fd >= 0) ::close(s->fd);
  delete s;
}

int64_t tario_count(void* handle) {
  auto* s = static_cast<Shard*>(handle);
  return s ? int64_t(s->entries.size()) : -1;
}

const char* tario_name(void* handle, int64_t i) {
  auto* s = static_cast<Shard*>(handle);
  if (!s || i < 0 || size_t(i) >= s->entries.size()) return nullptr;
  return s->entries[i].name.c_str();
}

int64_t tario_size(void* handle, int64_t i) {
  auto* s = static_cast<Shard*>(handle);
  if (!s || i < 0 || size_t(i) >= s->entries.size()) return -1;
  return int64_t(s->entries[i].size);
}

// Returns a pointer into the mmap — valid until tario_close. Zero-copy.
const uint8_t* tario_data(void* handle, int64_t i) {
  auto* s = static_cast<Shard*>(handle);
  if (!s || i < 0 || size_t(i) >= s->entries.size()) return nullptr;
  return s->map + s->entries[i].offset;
}

// Copying read for callers that want an owned buffer.
int64_t tario_read(void* handle, int64_t i, uint8_t* out, int64_t cap) {
  auto* s = static_cast<Shard*>(handle);
  if (!s || i < 0 || size_t(i) >= s->entries.size()) return -1;
  const Entry& e = s->entries[i];
  int64_t n = int64_t(e.size) < cap ? int64_t(e.size) : cap;
  memcpy(out, s->map + e.offset, n);
  return n;
}

}  // extern "C"
