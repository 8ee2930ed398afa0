// Edge runtime: native host-side plumbing for the realtime SLAM loop.
//
// C++ equivalent of the reference's node driver plumbing
// (/root/reference/src/rumi-slam/src/cloud_edge_main.cpp — Grabber::RunTxt
// :550 dataset replay with real-time pacing :597-610, rosbag/image staging,
// and scripts/nodes/pub_memory.py memory reporting).  The device compute
// path stays in JAX; this module owns what must NOT sit on the Python
// interpreter:
//   * a lock-free SPSC frame ring buffer between the IO/camera thread and
//     the tracking loop (drop-oldest policy, timestamped),
//   * a TUM-format dataset reader (rgb.txt + binary PGM/PPM decode) with a
//     background prefetch thread that paces frames at the recorded cadence,
//   * process RSS sampling for the memory metric in result.csv.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread edge_runtime.cpp -o libedgert.so

#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  double t;
  std::vector<float> data;
};

// ---------------------------------------------------------------------------
// SPSC ring buffer of frames.
// ---------------------------------------------------------------------------
struct FrameQueue {
  int h = 0, w = 0;
  size_t capacity = 0;
  std::vector<Frame> slots;
  std::atomic<uint64_t> head{0};  // next write
  std::atomic<uint64_t> tail{0};  // next read
  std::atomic<uint64_t> dropped{0};
};

// ---------------------------------------------------------------------------
// TUM dataset: rgb.txt lines "timestamp path" relative to the dataset dir.
// ---------------------------------------------------------------------------
struct TumEntry {
  double t;
  std::string path;
};

struct TumDataset {
  std::string root;
  std::vector<TumEntry> entries;
  std::thread prefetch;
  std::atomic<bool> stop{false};
  std::atomic<bool> done{false};
  double pace = 1.0;  // 1.0 = real-time; 0 = as fast as possible
};

bool read_pnm(const std::string& path, int* h, int* w, std::vector<float>* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  std::string magic;
  f >> magic;
  if (magic != "P5" && magic != "P6") return false;
  int width = 0, height = 0, maxval = 0;
  // skip comments
  auto next_int = [&](int* v) {
    while (true) {
      int c = f.peek();
      if (c == '#') { std::string line; std::getline(f, line); }
      else if (isspace(c)) { f.get(); }
      else break;
    }
    f >> *v;
  };
  next_int(&width);
  next_int(&height);
  next_int(&maxval);
  f.get();  // single whitespace after header
  const int ch = (magic == "P6") ? 3 : 1;
  const bool two_byte = maxval > 255;
  std::vector<unsigned char> buf((size_t)width * height * ch * (two_byte ? 2 : 1));
  f.read(reinterpret_cast<char*>(buf.data()), buf.size());
  if (!f) return false;
  out->resize((size_t)width * height);
  for (int i = 0; i < width * height; ++i) {
    float v;
    if (two_byte) {
      int base = i * ch * 2;
      // grayscale from first channel, big-endian 16-bit
      v = (buf[base] * 256 + buf[base + 1]) * (255.0f / maxval);
    } else if (ch == 3) {
      int base = i * 3;
      v = 0.299f * buf[base] + 0.587f * buf[base + 1] + 0.114f * buf[base + 2];
    } else {
      v = buf[i];
    }
    (*out)[i] = v;
  }
  *h = height;
  *w = width;
  return true;
}

}  // namespace

extern "C" {

// ----------------------------- frame queue --------------------------------
void* frq_create(int capacity, int h, int w) {
  auto* q = new FrameQueue();
  q->h = h;
  q->w = w;
  q->capacity = (size_t)capacity;
  q->slots.resize(capacity);
  for (auto& s : q->slots) s.data.resize((size_t)h * w);
  return q;
}

void frq_destroy(void* hq) { delete static_cast<FrameQueue*>(hq); }

// Push a frame; drops the OLDEST pending frame when full (a realtime camera
// never blocks — the reference similarly skips frames that fall behind).
int frq_push(void* hq, double t, const float* data) {
  auto* q = static_cast<FrameQueue*>(hq);
  uint64_t head = q->head.load(std::memory_order_relaxed);
  uint64_t tail = q->tail.load(std::memory_order_acquire);
  if (head - tail >= q->capacity) {
    q->tail.compare_exchange_strong(tail, tail + 1);  // drop oldest
    q->dropped.fetch_add(1, std::memory_order_relaxed);
  }
  Frame& s = q->slots[head % q->capacity];
  s.t = t;
  std::memcpy(s.data.data(), data, sizeof(float) * q->h * q->w);
  q->head.store(head + 1, std::memory_order_release);
  return 1;
}

// Pop into caller buffer; returns 0 if empty.
int frq_pop(void* hq, double* t, float* out) {
  auto* q = static_cast<FrameQueue*>(hq);
  uint64_t tail = q->tail.load(std::memory_order_relaxed);
  if (tail >= q->head.load(std::memory_order_acquire)) return 0;
  Frame& s = q->slots[tail % q->capacity];
  *t = s.t;
  std::memcpy(out, s.data.data(), sizeof(float) * q->h * q->w);
  q->tail.store(tail + 1, std::memory_order_release);
  return 1;
}

int frq_size(void* hq) {
  auto* q = static_cast<FrameQueue*>(hq);
  return (int)(q->head.load() - q->tail.load());
}

long frq_dropped(void* hq) {
  return (long)static_cast<FrameQueue*>(hq)->dropped.load();
}

// ----------------------------- TUM dataset --------------------------------
void* tum_open(const char* root, const char* index_file) {
  auto* d = new TumDataset();
  d->root = root;
  std::ifstream f(std::string(root) + "/" + index_file);
  if (!f) { delete d; return nullptr; }
  std::string line;
  while (std::getline(f, line)) {
    if (line.empty() || line[0] == '#') continue;
    std::istringstream ss(line);
    TumEntry e;
    ss >> e.t >> e.path;
    if (!e.path.empty()) d->entries.push_back(e);
  }
  return d;
}

int tum_size(void* hd) { return (int)static_cast<TumDataset*>(hd)->entries.size(); }

double tum_timestamp(void* hd, int i) {
  return static_cast<TumDataset*>(hd)->entries[i].t;
}

// Decode frame i into out (caller allocates h*w floats from tum_probe).
int tum_read(void* hd, int i, int* h, int* w, float* out, int max_pixels) {
  auto* d = static_cast<TumDataset*>(hd);
  if (i < 0 || i >= (int)d->entries.size()) return 0;
  std::vector<float> buf;
  if (!read_pnm(d->root + "/" + d->entries[i].path, h, w, &buf)) return 0;
  if ((int)buf.size() > max_pixels) return 0;
  std::memcpy(out, buf.data(), buf.size() * sizeof(float));
  return 1;
}

// Background prefetch: replay the dataset into a frame queue at `pace` x
// real time (pace<=0: as fast as the queue drains).  The Python tracking
// loop just pops — identical role to the reference's paced RunTxt loop.
int tum_start_replay(void* hd, void* hq, double pace) {
  auto* d = static_cast<TumDataset*>(hd);
  auto* q = static_cast<FrameQueue*>(hq);
  d->pace = pace;
  d->stop = false;
  d->done = false;
  d->prefetch = std::thread([d, q]() {
    using clock = std::chrono::steady_clock;
    auto start = clock::now();
    double t0 = d->entries.empty() ? 0.0 : d->entries.front().t;
    std::vector<float> buf;
    int h, w;
    for (size_t i = 0; i < d->entries.size() && !d->stop; ++i) {
      if (!read_pnm(d->root + "/" + d->entries[i].path, &h, &w, &buf)) continue;
      if (d->pace > 0) {
        double target = (d->entries[i].t - t0) / d->pace;
        std::this_thread::sleep_until(
            start + std::chrono::duration<double>(target));
      } else {
        while (!d->stop &&
               q->head.load() - q->tail.load() >= q->capacity - 1) {
          std::this_thread::sleep_for(std::chrono::microseconds(200));
        }
      }
      frq_push(q, d->entries[i].t, buf.data());
    }
    d->done = true;
  });
  return 1;
}

int tum_replay_done(void* hd) { return static_cast<TumDataset*>(hd)->done ? 1 : 0; }

void tum_close(void* hd) {
  auto* d = static_cast<TumDataset*>(hd);
  d->stop = true;
  if (d->prefetch.joinable()) d->prefetch.join();
  delete d;
}

// ----------------------------- process stats ------------------------------
long rt_rss_bytes() {
  std::ifstream f("/proc/self/statm");
  long total = 0, rss = 0;
  if (f >> total >> rss) return rss * sysconf(_SC_PAGESIZE);
  return -1;
}

}  // extern "C"
