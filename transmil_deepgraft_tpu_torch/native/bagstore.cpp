// bagstore: memory-mapped slide-feature store with threaded batch assembly.
//
// The reference framework's input hot loop is h5py-per-item reads in DataLoader
// worker processes (feature_dataloader.py get_data). This native store packs a
// cohort of per-slide feature bags into one file:
//
//   [header][slide index][coords blob][feature blob]
//
//   header:  magic 'BAGS' u32 | version u32 | n_slides u64 | dim u64
//   index:   per slide: feat_offset u64, coord_offset u64, n_tiles u64
//   coords:  int32 (n_tiles, 2) per slide
//   feats:   float32 (n_tiles, dim) per slide
//
// and serves it via mmap: full-bag reads are a single memcpy from the page
// cache, random subsampling copies only the k sampled rows, and batch assembly
// fans out across std::threads writing straight into a caller-provided numpy
// buffer (zero staging copies). Exposed through a plain C ABI for ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread bagstore.cpp -o libbagstore.so

#include <atomic>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x53474142;  // 'BAGS'
constexpr uint32_t kVersion = 1;

struct Header {
  uint32_t magic;
  uint32_t version;
  uint64_t n_slides;
  uint64_t dim;
};

struct SlideEntry {
  uint64_t feat_offset;   // bytes from file start
  uint64_t coord_offset;  // bytes from file start
  uint64_t n_tiles;
};

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  Header header{};
  const SlideEntry* index = nullptr;
};

}  // namespace

extern "C" {

// Returns an opaque handle (heap pointer) or nullptr on failure.
void* bagstore_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = ::mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Store();
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(base);
  s->size = st.st_size;
  // Validate EVERYTHING the later zero-copy reads rely on, at open time:
  // a truncated or corrupt store must fail here with nullptr, not SIGBUS
  // (or silently return garbage) inside a memcpy from beyond the mapping.
  auto fail = [&]() {
    ::munmap(base, st.st_size);
    ::close(fd);
    delete s;
    return static_cast<void*>(nullptr);
  };
  if (s->size < sizeof(Header)) return fail();
  std::memcpy(&s->header, s->base, sizeof(Header));
  if (s->header.magic != kMagic || s->header.version != kVersion) return fail();
  const uint64_t n = s->header.n_slides;
  const uint64_t dim = s->header.dim;
  if (dim == 0 || dim > s->size || n > (s->size - sizeof(Header)) / sizeof(SlideEntry))
    return fail();
  s->index = reinterpret_cast<const SlideEntry*>(s->base + sizeof(Header));
  for (uint64_t i = 0; i < n; ++i) {
    const SlideEntry& e = s->index[i];
    if (e.n_tiles > s->size / (dim * sizeof(float))) return fail();  // overflow guard
    const uint64_t feat_bytes = e.n_tiles * dim * sizeof(float);
    const uint64_t coord_bytes = e.n_tiles * 2 * sizeof(int32_t);
    if (e.feat_offset > s->size || feat_bytes > s->size - e.feat_offset) return fail();
    if (e.coord_offset > s->size || coord_bytes > s->size - e.coord_offset) return fail();
  }
  return s;
}

void bagstore_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return;
  ::munmap(const_cast<uint8_t*>(s->base), s->size);
  ::close(s->fd);
  delete s;
}

uint64_t bagstore_n_slides(void* handle) {
  return static_cast<Store*>(handle)->header.n_slides;
}

uint64_t bagstore_dim(void* handle) {
  return static_cast<Store*>(handle)->header.dim;
}

uint64_t bagstore_n_tiles(void* handle, uint64_t slide) {
  auto* s = static_cast<Store*>(handle);
  if (slide >= s->header.n_slides) return 0;
  return s->index[slide].n_tiles;
}

// Copy the full bag (n_tiles x dim float32) into out.
int bagstore_read_bag(void* handle, uint64_t slide, float* out) {
  auto* s = static_cast<Store*>(handle);
  if (slide >= s->header.n_slides) return -1;
  const SlideEntry& e = s->index[slide];
  std::memcpy(out, s->base + e.feat_offset,
              e.n_tiles * s->header.dim * sizeof(float));
  return 0;
}

int bagstore_read_coords(void* handle, uint64_t slide, int32_t* out) {
  auto* s = static_cast<Store*>(handle);
  if (slide >= s->header.n_slides) return -1;
  const SlideEntry& e = s->index[slide];
  std::memcpy(out, s->base + e.coord_offset, e.n_tiles * 2 * sizeof(int32_t));
  return 0;
}

// Sample k tiles (permutation-without-replacement when k <= n, repeating the
// permutation otherwise), copying only the sampled rows. Zero-pads to k rows
// when the bag is smaller and pad_to_k != 0. Returns rows written (pre-pad).
int64_t bagstore_sample_bag(void* handle, uint64_t slide, uint64_t k,
                            uint64_t seed, int pad_to_k, float* out,
                            int32_t* coords_out) {
  auto* s = static_cast<Store*>(handle);
  if (slide >= s->header.n_slides) return -1;
  const SlideEntry& e = s->index[slide];
  const uint64_t n = e.n_tiles;
  const uint64_t dim = s->header.dim;
  const float* feats = reinterpret_cast<const float*>(s->base + e.feat_offset);
  const int32_t* coords =
      reinterpret_cast<const int32_t*>(s->base + e.coord_offset);

  std::mt19937_64 rng(seed);
  std::vector<uint64_t> perm(n);
  for (uint64_t i = 0; i < n; ++i) perm[i] = i;
  // Fisher-Yates for the first min(k, n) positions.
  const uint64_t take = k < n ? k : n;
  for (uint64_t i = 0; i < take; ++i) {
    uint64_t j = i + rng() % (n - i);
    std::swap(perm[i], perm[j]);
  }
  for (uint64_t i = 0; i < take; ++i) {
    std::memcpy(out + i * dim, feats + perm[i] * dim, dim * sizeof(float));
    if (coords_out) {
      coords_out[2 * i] = coords[2 * perm[i]];
      coords_out[2 * i + 1] = coords[2 * perm[i] + 1];
    }
  }
  if (pad_to_k && take < k) {
    std::memset(out + take * dim, 0, (k - take) * dim * sizeof(float));
    if (coords_out)
      std::memset(coords_out + 2 * take, 0, (k - take) * 2 * sizeof(int32_t));
  }
  return static_cast<int64_t>(take);
}

// Assemble a training batch: for each of batch_size slides, sample k tiles into
// out[b] (batch_size x k x dim), fanned out over n_threads.
int bagstore_assemble_batch(void* handle, const uint64_t* slides,
                            uint64_t batch_size, uint64_t k, uint64_t seed,
                            int n_threads, float* out) {
  auto* s = static_cast<Store*>(handle);
  const uint64_t dim = s->header.dim;
  std::atomic<uint64_t> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    for (uint64_t b = next.fetch_add(1); b < batch_size;
         b = next.fetch_add(1)) {
      int64_t r = bagstore_sample_bag(handle, slides[b], k, seed + b * 9973 + 1,
                                      /*pad_to_k=*/1, out + b * k * dim,
                                      nullptr);
      if (r < 0) err.store(1);
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return err.load() ? -1 : 0;
}

// ---- Writer (single pass, used by the Python converter) -------------------

// Writes a complete store given flattened inputs.
int bagstore_write(const char* path, uint64_t n_slides, uint64_t dim,
                   const uint64_t* n_tiles_per_slide, const float* all_feats,
                   const int32_t* all_coords) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  Header h{kMagic, kVersion, n_slides, dim};
  fwrite(&h, sizeof(h), 1, f);

  uint64_t coord_base = sizeof(Header) + n_slides * sizeof(SlideEntry);
  uint64_t total_tiles = 0;
  for (uint64_t i = 0; i < n_slides; ++i) total_tiles += n_tiles_per_slide[i];
  uint64_t feat_base = coord_base + total_tiles * 2 * sizeof(int32_t);

  uint64_t coff = coord_base, foff = feat_base;
  for (uint64_t i = 0; i < n_slides; ++i) {
    SlideEntry e{foff, coff, n_tiles_per_slide[i]};
    fwrite(&e, sizeof(e), 1, f);
    coff += n_tiles_per_slide[i] * 2 * sizeof(int32_t);
    foff += n_tiles_per_slide[i] * dim * sizeof(float);
  }
  fwrite(all_coords, sizeof(int32_t), total_tiles * 2, f);
  fwrite(all_feats, sizeof(float), total_tiles * dim, f);
  fclose(f);
  return 0;
}

}  // extern "C"
