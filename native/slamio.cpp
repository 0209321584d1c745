// slamio: native dataset prefetcher for the SLAM host runtime.
//
// The reference is a single-process C++ system whose drivers decode images on
// the critical path (Examples/ROS nodes; upstream mono_euroc loops). Here the
// host runtime around the device programs gets a native data pipeline instead:
// a pool of worker threads decodes frames (PGM / NPY / PNG-gray via libpng)
// ahead of the tracking loop into a bounded in-order ring, so image IO never
// stalls a device step. Exposed as a C ABI consumed from Python via ctypes
// (orb_slam3_comments_ghr_tpu/io/native_loader.py).
//
// Build: see native/build.sh (g++ -O3 -shared -fPIC slamio.cpp -lpng -lz).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <png.h>

namespace {

struct Image {
  int h = 0, w = 0;
  std::vector<float> data;  // grayscale float32
  bool ok = false;
};

bool decode_pgm(const std::string& path, Image* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  char magic[3] = {0};
  int w, h, maxv;
  if (fscanf(f, "%2s %d %d %d", magic, &w, &h, &maxv) != 4 ||
      strcmp(magic, "P5") != 0) {
    fclose(f);
    return false;
  }
  fgetc(f);  // single whitespace after header
  std::vector<uint8_t> buf((size_t)w * h);
  size_t n = fread(buf.data(), 1, buf.size(), f);
  fclose(f);
  if (n != buf.size()) return false;
  out->h = h; out->w = w;
  out->data.resize(buf.size());
  for (size_t i = 0; i < buf.size(); ++i) out->data[i] = (float)buf[i];
  out->ok = true;
  return true;
}

// Minimal NPY reader: C-order 2D arrays of float32/float64/uint8.
bool decode_npy(const std::string& path, Image* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  uint8_t magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, "\x93NUMPY", 6) != 0) {
    fclose(f);
    return false;
  }
  uint16_t hlen16 = 0;
  uint32_t hlen = 0;
  if (magic[6] == 1) {
    if (fread(&hlen16, 2, 1, f) != 1) { fclose(f); return false; }
    hlen = hlen16;
  } else {
    if (fread(&hlen, 4, 1, f) != 1) { fclose(f); return false; }
  }
  std::string header(hlen, '\0');
  if (fread(&header[0], 1, hlen, f) != hlen) { fclose(f); return false; }
  auto find_shape = [&](int* h, int* w) {
    size_t p = header.find("'shape':");
    if (p == std::string::npos) return false;
    return sscanf(header.c_str() + p, "'shape': (%d, %d)", h, w) == 2;
  };
  int h = 0, w = 0;
  if (!find_shape(&h, &w)) { fclose(f); return false; }
  bool f4 = header.find("<f4") != std::string::npos;
  bool f8 = header.find("<f8") != std::string::npos;
  bool u1 = header.find("|u1") != std::string::npos;
  size_t count = (size_t)h * w;
  out->h = h; out->w = w;
  out->data.resize(count);
  bool ok = false;
  if (f4) {
    ok = fread(out->data.data(), 4, count, f) == count;
  } else if (f8) {
    std::vector<double> tmp(count);
    ok = fread(tmp.data(), 8, count, f) == count;
    for (size_t i = 0; i < count; ++i) out->data[i] = (float)tmp[i];
  } else if (u1) {
    std::vector<uint8_t> tmp(count);
    ok = fread(tmp.data(), 1, count, f) == count;
    for (size_t i = 0; i < count; ++i) out->data[i] = (float)tmp[i];
  }
  fclose(f);
  out->ok = ok;
  return ok;
}

bool decode_png(const std::string& path, Image* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  // normalize to 8-bit grayscale
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  int color = png_get_color_type(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color & PNG_COLOR_MASK_COLOR) png_set_rgb_to_gray(png, 1, -1, -1);
  png_read_update_info(png, info);
  std::vector<uint8_t> row(png_get_rowbytes(png, info));
  out->h = (int)h; out->w = (int)w;
  out->data.resize((size_t)h * w);
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    for (png_uint_32 x = 0; x < w; ++x)
      out->data[(size_t)y * w + x] = (float)row[x];
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  out->ok = true;
  return true;
}

bool decode(const std::string& path, Image* out) {
  auto dot = path.rfind('.');
  std::string ext = dot == std::string::npos ? "" : path.substr(dot);
  if (ext == ".pgm") return decode_pgm(path, out);
  if (ext == ".npy") return decode_npy(path, out);
  if (ext == ".png") return decode_png(path, out);
  return decode_pgm(path, out) || decode_npy(path, out) || decode_png(path, out);
}

struct Loader {
  std::vector<std::string> paths;
  std::map<size_t, Image> ready;   // decoded frames by index
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<size_t> next_to_fetch{0};
  size_t next_to_serve = 0;
  size_t capacity = 8;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      size_t idx = next_to_fetch.fetch_add(1);
      if (idx >= paths.size() || stop.load()) return;
      Image img;
      decode(paths[idx], &img);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() || idx < next_to_serve + capacity;
      });
      if (stop.load()) return;
      ready[idx] = std::move(img);
      cv_ready.notify_all();
    }
  }
};

std::mutex g_mu;
std::map<int64_t, Loader*> g_loaders;
int64_t g_next_handle = 1;

}  // namespace

extern "C" {

int64_t slamio_open(const char** paths, int64_t n, int64_t n_workers,
                    int64_t capacity) {
  auto* l = new Loader();
  l->paths.assign(paths, paths + n);
  l->capacity = (size_t)capacity;
  int64_t nw = n_workers < 1 ? 1 : n_workers;
  for (int64_t i = 0; i < nw; ++i)
    l->workers.emplace_back([l] { l->worker(); });
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next_handle++;
  g_loaders[h] = l;
  return h;
}

// Blocks until frame `idx` (served strictly in order) is decoded. Returns
// 1 on success, 0 on decode failure, -1 past end. h/w report dimensions;
// buf must hold max_h*max_w floats.
int32_t slamio_next(int64_t handle, float* buf, int64_t max_elems,
                    int32_t* h, int32_t* w) {
  Loader* l;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_loaders.find(handle);
    if (it == g_loaders.end()) return -1;
    l = it->second;
  }
  std::unique_lock<std::mutex> lk(l->mu);
  size_t idx = l->next_to_serve;
  if (idx >= l->paths.size()) return -1;
  l->cv_ready.wait(lk, [&] { return l->ready.count(idx) > 0; });
  Image img = std::move(l->ready[idx]);
  l->ready.erase(idx);
  l->next_to_serve++;
  l->cv_space.notify_all();
  lk.unlock();
  if (!img.ok) { *h = 0; *w = 0; return 0; }
  *h = img.h; *w = img.w;
  size_t count = (size_t)img.h * img.w;
  if ((int64_t)count > max_elems) return 0;
  memcpy(buf, img.data.data(), count * sizeof(float));
  return 1;
}

void slamio_close(int64_t handle) {
  Loader* l = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_loaders.find(handle);
    if (it == g_loaders.end()) return;
    l = it->second;
    g_loaders.erase(it);
  }
  l->stop.store(true);
  l->cv_space.notify_all();
  l->cv_ready.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

}  // extern "C"
