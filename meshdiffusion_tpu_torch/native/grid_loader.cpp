// Native grid data loader: .npy decode + augmentation + batch assembly.
// (This package's own copy of meshdiffusion_tpu/native/grid_loader.cpp,
// built by grid_loader.py beside it.)
//
// C++ counterpart of the hot path of the reference's DataLoader worker
// processes (reference lib/dataset/shapenet_dmtet_dataset.py:32-54 +
// trainer.py:72-75): per sample, load a (4, r, r, r) float32 .npy grid,
// sign-normalize the SDF channel, apply the global +-0.005 deformation
// jitter on nonempty cells, multiply by the grid mask, zero-pad r -> R, and
// write the result channels-LAST into a caller-provided batch buffer.
// A persistent thread pool fills whole batches in parallel; the Python
// binding (grid_loader.py) drives it via ctypes with zero-copy numpy
// buffers.
//
// Only the .npy subset that numpy writes for a float array is supported:
// C-order float32/float64, little-endian, v1/v2 headers (torch .pt files go
// to the Python loader).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyArray {
  std::vector<float> data;
  std::vector<int64_t> shape;
};

// minimal .npy reader (v1/v2, C-order, <f4 or <f8)
bool load_npy(const char* path, NpyArray* out, std::string* err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { *err = std::string("open failed: ") + path; return false; }
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 ||
      std::memcmp(magic, "\x93NUMPY", 6) != 0) {
    *err = "bad magic"; std::fclose(f); return false;
  }
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (std::fread(b, 1, 2, f) != 2) { *err = "short header"; std::fclose(f); return false; }
    header_len = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (std::fread(b, 1, 4, f) != 4) { *err = "short header"; std::fclose(f); return false; }
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (uint32_t(b[3]) << 24);
  }
  std::string header(header_len, '\0');
  if (std::fread(&header[0], 1, header_len, f) != header_len) {
    *err = "short header body"; std::fclose(f); return false;
  }
  bool f8 = header.find("<f8") != std::string::npos;
  if (!f8 && header.find("<f4") == std::string::npos) {
    *err = "unsupported dtype (need <f4/<f8): " + header; std::fclose(f); return false;
  }
  if (header.find("'fortran_order': True") != std::string::npos) {
    *err = "fortran order unsupported"; std::fclose(f); return false;
  }
  size_t sp = header.find("'shape':");
  size_t lp = header.find('(', sp), rp = header.find(')', sp);
  if (sp == std::string::npos || lp == std::string::npos || rp == std::string::npos) {
    *err = "no shape"; std::fclose(f); return false;
  }
  std::string dims = header.substr(lp + 1, rp - lp - 1);
  out->shape.clear();
  int64_t total = 1;
  const char* p = dims.c_str();
  while (*p) {
    while (*p == ' ' || *p == ',') ++p;
    if (!*p) break;
    int64_t v = std::strtoll(p, const_cast<char**>(&p), 10);
    out->shape.push_back(v);
    total *= v;
  }
  out->data.resize(total);
  if (f8) {
    std::vector<double> tmp(total);
    if (std::fread(tmp.data(), 8, total, f) != size_t(total)) {
      *err = "short data"; std::fclose(f); return false;
    }
    for (int64_t i = 0; i < total; ++i) out->data[i] = float(tmp[i]);
  } else {
    if (std::fread(out->data.data(), 4, total, f) != size_t(total)) {
      *err = "short data"; std::fclose(f); return false;
    }
  }
  std::fclose(f);
  return true;
}

struct LoaderState {
  std::vector<std::string> paths;
  std::vector<float> grid_mask;  // (R*R*R)
  int resolution = 64;
  bool aug = true;
  bool normalize_sdf = true;
  uint64_t seed = 0;
  std::vector<std::thread> workers;
  // job queue: (sample index in dataset, slot in batch buffer)
  std::mutex mu;
  std::condition_variable cv_job, cv_done;
  std::queue<std::pair<int64_t, int64_t>> jobs;
  float* batch_out = nullptr;  // (B, R, R, R, 4) channels-last
  std::atomic<int> pending{0};
  std::atomic<bool> stop{false};
  std::string last_error;
  // samples filled before the current fill: a sample's jitter is drawn from
  // its place in the stream, whichever worker takes it, so two loaders with
  // one seed and one index stream give the same batches (spatial peers)
  uint64_t fill_base = 0;

  ~LoaderState() {
    stop.store(true);
    cv_job.notify_all();
    for (auto& t : workers) if (t.joinable()) t.join();
  }
};

// one sample: load + normalize + jitter + mask + pad, channels-last output
bool process_sample(LoaderState* st, int64_t idx, float* dst, uint64_t ordinal) {
  NpyArray arr;
  std::string err;
  if (!load_npy(st->paths[idx].c_str(), &arr, &err)) {
    std::lock_guard<std::mutex> lk(st->mu);
    st->last_error = err;
    return false;
  }
  if (arr.shape.size() != 4 || arr.shape[0] != 4) {
    std::lock_guard<std::mutex> lk(st->mu);
    st->last_error = "expected (4, r, r, r) grid: " + st->paths[idx];
    return false;
  }
  const int64_t r = arr.shape[1];
  const int64_t R = st->resolution;
  if (r > R || arr.shape[2] != r || arr.shape[3] != r) {
    std::lock_guard<std::mutex> lk(st->mu);
    st->last_error = "grid not (4, r, r, r) with r <= the mask's R: " + st->paths[idx];
    return false;
  }
  const float* g = arr.data.data();
  const int64_t rr = r * r, rrr = r * r * r;

  // global deform jitter (reference shapenet_dmtet_dataset.py:42-44):
  // one uniform(-0.5, 0.5)*0.01/(r/R) offset per deform channel per sample
  float jit[3] = {0.f, 0.f, 0.f};
  if (st->aug) {
    std::mt19937_64 rng(st->seed ^ (0x9E3779B97F4A7C15ULL * ordinal));
    std::uniform_real_distribution<float> uni(-0.5f, 0.5f);
    const float scale = 0.01f / (float(r) / float(R));
    for (int c = 0; c < 3; ++c) jit[c] = uni(rng) * scale;
  }

  std::memset(dst, 0, sizeof(float) * R * R * R * 4);
  for (int64_t x = 0; x < r; ++x) {
    for (int64_t y = 0; y < r; ++y) {
      for (int64_t z = 0; z < r; ++z) {
        const int64_t si = x * rr + y * r + z;
        float sdf = g[si];
        float d1 = g[rrr + si], d2 = g[2 * rrr + si], d3 = g[3 * rrr + si];
        if (st->normalize_sdf) sdf = (sdf < 0.f) ? -1.f : 1.f;
        if (st->aug) {
          const bool nonempty = (std::abs(d1) + std::abs(d2) + std::abs(d3)) != 0.f;
          if (nonempty) { d1 += jit[0]; d2 += jit[1]; d3 += jit[2]; }
          const float m = st->grid_mask[(x * R + y) * R + z];
          sdf *= m; d1 *= m; d2 *= m; d3 *= m;
        }
        float* o = dst + ((x * R + y) * R + z) * 4;
        o[0] = sdf; o[1] = d1; o[2] = d2; o[3] = d3;
      }
    }
  }
  return true;
}

void worker_loop(LoaderState* st) {
  for (;;) {
    std::pair<int64_t, int64_t> job;
    {
      std::unique_lock<std::mutex> lk(st->mu);
      st->cv_job.wait(lk, [&] { return st->stop.load() || !st->jobs.empty(); });
      if (st->stop.load()) return;
      job = st->jobs.front();
      st->jobs.pop();
    }
    const int64_t R = st->resolution;
    float* dst = st->batch_out + job.second * R * R * R * 4;
    process_sample(st, job.first, dst, st->fill_base + uint64_t(job.second));
    if (st->pending.fetch_sub(1) == 1) st->cv_done.notify_all();
  }
}

}  // namespace

extern "C" {

void* grid_loader_create(const char** paths, int64_t n_paths,
                         const float* grid_mask, int resolution,
                         int aug, int normalize_sdf, uint64_t seed,
                         int num_workers) {
  auto* st = new LoaderState();
  st->paths.assign(paths, paths + n_paths);
  st->grid_mask.assign(grid_mask,
                       grid_mask + int64_t(resolution) * resolution * resolution);
  st->resolution = resolution;
  st->aug = aug != 0;
  st->normalize_sdf = normalize_sdf != 0;
  st->seed = seed;
  if (num_workers < 1) num_workers = 1;
  for (int i = 0; i < num_workers; ++i)
    st->workers.emplace_back(worker_loop, st);
  return st;
}

// Fill batch_out (B, R, R, R, 4) float32 with the given dataset indices.
// Returns 0 on success.
int grid_loader_fill(void* handle, const int64_t* indices, int64_t batch,
                     float* batch_out) {
  auto* st = static_cast<LoaderState*>(handle);
  {
    std::lock_guard<std::mutex> lk(st->mu);
    st->batch_out = batch_out;
    st->last_error.clear();
    st->pending.store(int(batch));
    for (int64_t b = 0; b < batch; ++b)
      st->jobs.emplace(indices[b], b);
  }
  st->cv_job.notify_all();
  {
    std::unique_lock<std::mutex> lk(st->mu);
    st->cv_done.wait(lk, [&] { return st->pending.load() == 0; });
    st->fill_base += uint64_t(batch);
    if (!st->last_error.empty()) return 1;
  }
  return 0;
}

const char* grid_loader_last_error(void* handle) {
  auto* st = static_cast<LoaderState*>(handle);
  std::lock_guard<std::mutex> lk(st->mu);
  return st->last_error.c_str();  // valid until next fill
}

void grid_loader_destroy(void* handle) {
  delete static_cast<LoaderState*>(handle);
}

}  // extern "C"
