// packio: mmap-backed packed-dataset reader for the gaiaseg data path.
//
// A copy of gaiaseg_tpu/native/packio.cc for the PyTorch/CUDA port; the
// .gsegpack format is the same byte for byte, so a file written by either
// package reads in the other. Datasets are converted once into a
// fixed-shape packed binary, and this library serves batches via mmap with
// no Python objects per record and no GIL during copies (ctypes releases
// the GIL on the call), so one loader thread keeps the card fed.
//
// Format (little endian):
//   magic   u32 = 0x47534547 ("GSEG")
//   version u32 = 1
//   n       u64   records
//   h, w    u32   record spatial shape
//   img_c   u32   image channels (3)
//   lab_c   u32   label channels (1, uint8 trainIds; 255 = ignore)
//   payload: n records of [h*w*img_c u8 image][h*w u8 label]
//
// Build: gaiaseg_tpu_torch/native/build.py (g++ -O3 -shared -fPIC,
// into gaiaseg_tpu_torch/_build/ at first use).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <thread>
#include <vector>

namespace {

struct Header {
  uint32_t magic;
  uint32_t version;
  uint64_t n;
  uint32_t h, w, img_c, lab_c;
};

struct Pack {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t mapped = 0;
  Header hdr{};
  size_t rec_bytes = 0;
  const uint8_t* payload = nullptr;
};

constexpr uint32_t kMagic = 0x47534547u;

// Gather `count` records by index into contiguous batch buffers.
// Labels on disk are u8; LabelT selects raw memcpy (u8 out) or widening
// (i32 out). 255 stays 255 either way, preserving the ignore index.
// (Outside the extern "C" block: templates cannot take C linkage.)
template <typename LabelT>
static int read_batch_impl(void* handle, const int64_t* indices,
                           int64_t count, uint8_t* imgs, LabelT* labels,
                           int num_threads) {
  auto* p = static_cast<Pack*>(handle);
  if (!p) return -1;
  const size_t img_bytes = (size_t)p->hdr.h * p->hdr.w * p->hdr.img_c;
  const size_t lab_elems = (size_t)p->hdr.h * p->hdr.w;

  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t idx = indices[i];
      if (idx < 0 || (uint64_t)idx >= p->hdr.n) continue;
      const uint8_t* rec = p->payload + (size_t)idx * p->rec_bytes;
      std::memcpy(imgs + (size_t)i * img_bytes, rec, img_bytes);
      const uint8_t* lab = rec + img_bytes;
      LabelT* out = labels + (size_t)i * lab_elems;
      if (sizeof(LabelT) == 1) {
        std::memcpy(out, lab, lab_elems);
      } else {
        for (size_t j = 0; j < lab_elems; ++j) out[j] = lab[j];
      }
    }
  };

  if (num_threads <= 1 || count <= 1) {
    work(0, count);
    return 0;
  }
  int t = num_threads < (int)count ? num_threads : (int)count;
  std::vector<std::thread> threads;
  int64_t per = (count + t - 1) / t;
  for (int k = 0; k < t; ++k) {
    int64_t lo = k * per;
    int64_t hi = lo + per < count ? lo + per : count;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // namespace

extern "C" {

// Returns an opaque handle (heap pointer) or nullptr on failure.
void* packio_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(Header)) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* p = new Pack();
  p->fd = fd;
  p->base = static_cast<const uint8_t*>(mem);
  p->mapped = st.st_size;
  std::memcpy(&p->hdr, p->base, sizeof(Header));
  if (p->hdr.magic != kMagic || p->hdr.version != 1) {
    munmap(mem, st.st_size);
    ::close(fd);
    delete p;
    return nullptr;
  }
  p->rec_bytes = (size_t)p->hdr.h * p->hdr.w * (p->hdr.img_c + p->hdr.lab_c);
  p->payload = p->base + sizeof(Header);
  if (sizeof(Header) + p->rec_bytes * p->hdr.n > p->mapped) {
    munmap(mem, st.st_size);
    ::close(fd);
    delete p;
    return nullptr;
  }
  // advise the kernel we'll read records in random order
  madvise(mem, st.st_size, MADV_RANDOM);
  return p;
}

void packio_close(void* handle) {
  auto* p = static_cast<Pack*>(handle);
  if (!p) return;
  munmap(const_cast<uint8_t*>(p->base), p->mapped);
  ::close(p->fd);
  delete p;
}

int64_t packio_len(void* handle) {
  auto* p = static_cast<Pack*>(handle);
  return p ? (int64_t)p->hdr.n : -1;
}

// out_shape: int64[4] = {h, w, img_c, lab_c}
int packio_shape(void* handle, int64_t* out_shape) {
  auto* p = static_cast<Pack*>(handle);
  if (!p) return -1;
  out_shape[0] = p->hdr.h;
  out_shape[1] = p->hdr.w;
  out_shape[2] = p->hdr.img_c;
  out_shape[3] = p->hdr.lab_c;
  return 0;
}

// imgs: u8 [count, h, w, img_c]; labels: i32 [count, h, w] (widened).
int packio_read_batch(void* handle, const int64_t* indices, int64_t count,
                      uint8_t* imgs, int32_t* labels, int num_threads) {
  return read_batch_impl(handle, indices, count, imgs, labels, num_threads);
}

// Same gather, labels raw u8 — the on-disk dtype. Consumers that do
// arithmetic on labels cast on device; shipping u8 keeps host casts and
// host->device bytes 4x smaller.
int packio_read_batch_u8(void* handle, const int64_t* indices, int64_t count,
                         uint8_t* imgs, uint8_t* labels, int num_threads) {
  return read_batch_impl(handle, indices, count, imgs, labels, num_threads);
}

// Writer used by pack_dataset (data/packed.py): create file + header, then records
// are appended from Python via packio_append.
void* packio_create(const char* path, uint64_t n, uint32_t h, uint32_t w,
                    uint32_t img_c, uint32_t lab_c) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Header hdr{kMagic, 1, n, h, w, img_c, lab_c};
  if (fwrite(&hdr, sizeof(Header), 1, f) != 1) {
    fclose(f);
    return nullptr;
  }
  return f;
}

int packio_append(void* file, const uint8_t* img, const uint8_t* label,
                  uint64_t img_bytes, uint64_t lab_bytes) {
  FILE* f = static_cast<FILE*>(file);
  if (!f) return -1;
  if (fwrite(img, 1, img_bytes, f) != img_bytes) return -1;
  if (fwrite(label, 1, lab_bytes, f) != lab_bytes) return -1;
  return 0;
}

int packio_finish(void* file) {
  FILE* f = static_cast<FILE*>(file);
  if (!f) return -1;
  return fclose(f);
}

}  // extern "C"
