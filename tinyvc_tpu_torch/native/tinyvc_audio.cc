// Native audio runtime of the PyTorch port (a copy of the JAX package's
// native/tinyvc_audio.cc): WAV codec (PCM16/24/32/float32), windowed-sinc
// polyphase resampler, and a multithreaded prefetching dataset loader that
// serves ready-made {wave, f0} training batches so the device never waits
// on host IO. Exposed as a C ABI consumed via ctypes
// (tinyvc_tpu_torch/data/native_loader.py), which builds it with g++ at
// first use into tinyvc_tpu_torch/kernels/_build/.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

#pragma pack(push, 1)
struct WavHeader {
  char riff[4];
  uint32_t size;
  char wave[4];
};
#pragma pack(pop)

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(n));
  size_t got = std::fread(out->data(), 1, out->size(), f);
  std::fclose(f);
  return got == out->size();
}

// Decode a RIFF/WAVE buffer into interleaved float32. Returns false on any
// structural problem; the Python caller falls back to its own decoder.
bool decode_wav(const std::vector<uint8_t>& buf, std::vector<float>* pcm,
                int* sample_rate, int* channels) {
  if (buf.size() < 12 || std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0)
    return false;
  size_t pos = 12;
  uint16_t fmt = 0, nch = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;
  while (pos + 8 <= buf.size()) {
    const char* id = reinterpret_cast<const char*>(buf.data() + pos);
    uint32_t len;
    std::memcpy(&len, buf.data() + pos + 4, 4);
    pos += 8;
    if (pos + len > buf.size()) len = static_cast<uint32_t>(buf.size() - pos);
    if (std::memcmp(id, "fmt ", 4) == 0 && len >= 16) {
      std::memcpy(&fmt, buf.data() + pos, 2);
      std::memcpy(&nch, buf.data() + pos + 2, 2);
      std::memcpy(&sr, buf.data() + pos + 4, 4);
      std::memcpy(&bits, buf.data() + pos + 14, 2);
    } else if (std::memcmp(id, "data", 4) == 0) {
      data = buf.data() + pos;
      data_len = len;
    }
    pos += len + (len & 1);  // chunks are word-aligned
  }
  if (!data || nch == 0 || sr == 0) return false;
  // WAVE_FORMAT_EXTENSIBLE (0xFFFE) carries the real format in a subchunk;
  // PCM/float are the only layouts we produce, so accept 1, 3, 0xFFFE.
  if (fmt != 1 && fmt != 3 && fmt != 0xFFFE) return false;

  size_t bytes_per = bits / 8;
  if (bytes_per == 0) return false;
  size_t frames = data_len / (bytes_per * nch);
  pcm->resize(frames * nch);
  if (bits == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(data);
    for (size_t i = 0; i < frames * nch; ++i)
      (*pcm)[i] = static_cast<float>(s[i]) / 32768.0f;
  } else if (bits == 32 && fmt == 3) {
    std::memcpy(pcm->data(), data, frames * nch * 4);
  } else if (bits == 32) {
    const int32_t* s = reinterpret_cast<const int32_t*>(data);
    for (size_t i = 0; i < frames * nch; ++i)
      (*pcm)[i] = static_cast<float>(s[i]) / 2147483648.0f;
  } else if (bits == 24) {
    for (size_t i = 0; i < frames * nch; ++i) {
      const uint8_t* p = data + i * 3;
      int32_t v = (p[0] | (p[1] << 8) | (p[2] << 16)) << 8;
      (*pcm)[i] = static_cast<float>(v >> 8) / 8388608.0f;
    }
  } else {
    return false;
  }
  *sample_rate = sr;
  *channels = nch;
  return true;
}

// Minimal .npy reader: little-endian float32, 1-D or 2-D, C order.
bool read_npy_f32(const char* path, std::vector<float>* out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf) || buf.size() < 10) return false;
  if (std::memcmp(buf.data(), "\x93NUMPY", 6) != 0) return false;
  uint8_t major = buf[6];
  size_t header_len, header_off;
  if (major == 1) {
    uint16_t hl;
    std::memcpy(&hl, buf.data() + 8, 2);
    header_len = hl;
    header_off = 10;
  } else {
    uint32_t hl;
    std::memcpy(&hl, buf.data() + 8, 4);
    header_len = hl;
    header_off = 12;
  }
  std::string header(reinterpret_cast<const char*>(buf.data() + header_off),
                     header_len);
  if (header.find("'<f4'") == std::string::npos) return false;
  if (header.find("'fortran_order': True") != std::string::npos) return false;
  size_t start = header_off + header_len;
  size_t n = (buf.size() - start) / 4;
  out->resize(n);
  std::memcpy(out->data(), buf.data() + start, n * 4);
  return true;
}

// Polyphase windowed-sinc resampler (same construction as
// tinyvc_tpu/dsp/resample.py so host and device paths agree).
void resample_poly(const std::vector<float>& in, int sr_in, int sr_out,
                   std::vector<float>* out) {
  if (sr_in == sr_out) {
    *out = in;
    return;
  }
  int g = 1;
  for (int d = 1; d <= std::min(sr_in, sr_out); ++d)
    if (sr_in % d == 0 && sr_out % d == 0) g = d;
  int orig = sr_in / g, newf = sr_out / g;
  const int lw = 6;
  const double rolloff = 0.99;
  double cutoff = std::min(orig, newf) * rolloff / 2.0;
  int width = static_cast<int>(
      std::ceil(lw * orig / (std::min(orig, newf) * rolloff)));
  int taps = 2 * width + orig;
  // kernels[phase][tap]
  std::vector<std::vector<float>> kernels(newf, std::vector<float>(taps));
  for (int p = 0; p < newf; ++p) {
    for (int j = 0; j < taps; ++j) {
      double idx = static_cast<double>(j - width) / orig -
                   static_cast<double>(p) / newf;
      double t = idx * 2.0 * cutoff;
      if (t < -lw) t = -lw;
      if (t > lw) t = lw;
      double w = std::cos(t * M_PI / lw / 2.0);
      w *= w;
      double sinc = (t == 0.0) ? 1.0 : std::sin(M_PI * t) / (M_PI * t);
      kernels[p][j] = static_cast<float>(sinc * w * (2.0 * cutoff / orig));
    }
  }
  size_t in_len = in.size();
  size_t out_len =
      static_cast<size_t>(std::ceil(static_cast<double>(in_len) * newf / orig));
  out->assign(out_len, 0.0f);
  for (size_t o = 0; o < out_len; ++o) {
    int block = static_cast<int>(o / newf);
    int phase = static_cast<int>(o % newf);
    const std::vector<float>& k = kernels[phase];
    long base = static_cast<long>(block) * orig - width;
    float acc = 0.0f;
    for (int j = 0; j < taps; ++j) {
      long s = base + j;
      if (s >= 0 && s < static_cast<long>(in_len)) acc += k[j] * in[s];
    }
    (*out)[o] = acc;
  }
}

struct Batch {
  std::vector<float> wave;  // [batch * chunk_len]
  std::vector<float> f0;    // [batch * f0_len]
};

struct Loader {
  std::string dir;
  int batch, chunk_len, f0_len, sample_rate;
  int num_items = 0;
  std::vector<int> order;
  size_t cursor = 0;
  std::mt19937 rng;
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::queue<Batch*> ready;
  size_t max_ready = 4;
  std::atomic<bool> stop{false};
  // decode failures (unopenable / corrupt wav or f0.npy). Failed slots are
  // zero-filled so batch shapes stay static, but the count is exposed via
  // tvc_loader_error_count so callers can detect a rotten dataset cache
  // instead of silently training on silence.
  std::atomic<long> errors{0};
  std::vector<std::thread> threads;

  bool next_indices(std::vector<int>* idx) {
    std::unique_lock<std::mutex> lock(mu);
    idx->clear();
    for (int i = 0; i < batch; ++i) {
      if (cursor >= order.size()) {
        // new epoch: reshuffle
        std::shuffle(order.begin(), order.end(), rng);
        cursor = 0;
      }
      idx->push_back(order[cursor++]);
    }
    return true;
  }

  void worker() {
    std::vector<int> idx;
    while (!stop.load()) {
      next_indices(&idx);
      Batch* b = new Batch;
      b->wave.assign(static_cast<size_t>(batch) * chunk_len, 0.0f);
      b->f0.assign(static_cast<size_t>(batch) * f0_len, 0.0f);
      for (int i = 0; i < batch; ++i) {
        char path[4096];
        std::snprintf(path, sizeof(path), "%s/%d.wav", dir.c_str(), idx[i]);
        std::vector<uint8_t> raw;
        std::vector<float> pcm;
        int sr = 0, ch = 0;
        if (read_file(path, &raw) && decode_wav(raw, &pcm, &sr, &ch)) {
          // mono mixdown
          std::vector<float> mono(pcm.size() / ch);
          for (size_t t = 0; t < mono.size(); ++t) {
            float acc = 0;
            for (int c = 0; c < ch; ++c) acc += pcm[t * ch + c];
            mono[t] = acc / ch;
          }
          std::vector<float> res;
          if (sr != sample_rate)
            resample_poly(mono, sr, sample_rate, &res);
          else
            res.swap(mono);
          size_t n = std::min<size_t>(res.size(), chunk_len);
          std::memcpy(&b->wave[static_cast<size_t>(i) * chunk_len], res.data(),
                      n * sizeof(float));
        } else {
          errors.fetch_add(1);
        }
        std::snprintf(path, sizeof(path), "%s/%d.f0.npy", dir.c_str(), idx[i]);
        std::vector<float> f0;
        if (read_npy_f32(path, &f0)) {
          size_t n = std::min<size_t>(f0.size(), f0_len);
          std::memcpy(&b->f0[static_cast<size_t>(i) * f0_len], f0.data(),
                      n * sizeof(float));
        } else {
          errors.fetch_add(1);
        }
      }
      std::unique_lock<std::mutex> lock(mu);
      cv_put.wait(lock, [&] { return ready.size() < max_ready || stop.load(); });
      if (stop.load()) {
        delete b;
        return;
      }
      ready.push(b);
      cv_get.notify_one();
    }
  }
};

}  // namespace

extern "C" {

// ---- WAV / npy / resample ----

// Decodes path into *out (caller frees with tvc_free). Returns frame count
// or -1. Output is interleaved float32.
long tvc_load_wav(const char* path, float** out, int* sample_rate,
                  int* channels) {
  std::vector<uint8_t> buf;
  std::vector<float> pcm;
  if (!read_file(path, &buf) || !decode_wav(buf, &pcm, sample_rate, channels))
    return -1;
  *out = static_cast<float*>(std::malloc(pcm.size() * sizeof(float)));
  std::memcpy(*out, pcm.data(), pcm.size() * sizeof(float));
  return static_cast<long>(pcm.size() / *channels);
}

int tvc_save_wav(const char* path, const float* data, long frames,
                 int sample_rate) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_len = static_cast<uint32_t>(frames * 2);
  uint32_t riff_len = 36 + data_len;
  uint16_t fmt = 1, nch = 1, bits = 16, block = 2;
  uint32_t byterate = sample_rate * 2, sr = sample_rate, fmtlen = 16;
  std::fwrite("RIFF", 1, 4, f);
  std::fwrite(&riff_len, 4, 1, f);
  std::fwrite("WAVEfmt ", 1, 8, f);
  std::fwrite(&fmtlen, 4, 1, f);
  std::fwrite(&fmt, 2, 1, f);
  std::fwrite(&nch, 2, 1, f);
  std::fwrite(&sr, 4, 1, f);
  std::fwrite(&byterate, 4, 1, f);
  std::fwrite(&block, 2, 1, f);
  std::fwrite(&bits, 2, 1, f);
  std::fwrite("data", 1, 4, f);
  std::fwrite(&data_len, 4, 1, f);
  for (long i = 0; i < frames; ++i) {
    float v = data[i];
    if (v > 1.0f) v = 1.0f;
    if (v < -1.0f) v = -1.0f;
    int16_t s = static_cast<int16_t>(v * 32767.0f);
    std::fwrite(&s, 2, 1, f);
  }
  std::fclose(f);
  return 0;
}

long tvc_resample(const float* in, long in_len, int sr_in, int sr_out,
                  float** out) {
  std::vector<float> v(in, in + in_len), r;
  resample_poly(v, sr_in, sr_out, &r);
  *out = static_cast<float*>(std::malloc(r.size() * sizeof(float)));
  std::memcpy(*out, r.data(), r.size() * sizeof(float));
  return static_cast<long>(r.size());
}

void tvc_free(void* p) { std::free(p); }

// ---- prefetching dataset loader ----

void* tvc_loader_create(const char* dir, int num_items, int batch,
                        int chunk_len, int f0_len, int sample_rate,
                        int num_threads, uint64_t seed) {
  Loader* l = new Loader;
  l->dir = dir;
  l->batch = batch;
  l->chunk_len = chunk_len;
  l->f0_len = f0_len;
  l->sample_rate = sample_rate;
  l->num_items = num_items;
  l->order.resize(num_items);
  for (int i = 0; i < num_items; ++i) l->order[i] = i;
  l->rng.seed(seed);
  std::shuffle(l->order.begin(), l->order.end(), l->rng);
  if (num_threads < 1) num_threads = 1;
  for (int t = 0; t < num_threads; ++t)
    l->threads.emplace_back([l] { l->worker(); });
  return l;
}

// Copies the next ready batch into caller-provided buffers
// (wave: batch*chunk_len floats; f0: batch*f0_len floats).
int tvc_loader_next(void* handle, float* wave, float* f0) {
  Loader* l = static_cast<Loader*>(handle);
  Batch* b = nullptr;
  {
    std::unique_lock<std::mutex> lock(l->mu);
    l->cv_get.wait(lock, [&] { return !l->ready.empty() || l->stop.load(); });
    if (l->stop.load()) return -1;
    b = l->ready.front();
    l->ready.pop();
    l->cv_put.notify_one();
  }
  std::memcpy(wave, b->wave.data(), b->wave.size() * sizeof(float));
  std::memcpy(f0, b->f0.data(), b->f0.size() * sizeof(float));
  delete b;
  return 0;
}

// Cumulative decode-failure count (wav + f0 files that failed to open or
// parse and were zero-filled). Callers should treat nonzero as a corrupt
// dataset cache.
long tvc_loader_error_count(void* handle) {
  return static_cast<Loader*>(handle)->errors.load();
}

void tvc_loader_destroy(void* handle) {
  Loader* l = static_cast<Loader*>(handle);
  l->stop.store(true);
  l->cv_put.notify_all();
  l->cv_get.notify_all();
  for (auto& t : l->threads) t.join();
  while (!l->ready.empty()) {
    delete l->ready.front();
    l->ready.pop();
  }
  delete l;
}

}  // extern "C"
