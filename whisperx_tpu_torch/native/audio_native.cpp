// Native audio ingest: RIFF/WAVE decode + windowed-sinc polyphase resampling.
//
// The reference delegates decode/resample to the ffmpeg CLI
// (reference: whisperx/audio.py:44-61). This library removes that process
// boundary: WAV parsing is a single pass over the mapped file and the
// resampler is a Kaiser-windowed polyphase FIR (same design as
// scipy.signal.resample_poly's default), multithread-friendly and
// allocation-light. Exposed through ctypes (see native/__init__.py); the
// numpy implementation in audio/io.py is the correctness oracle.
//
// Build: g++ -O3 -shared -fPIC -o libwhisperx_audio.so audio_native.cpp

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <new>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------------

struct DecodedAudio {
  float* samples;  // interleaved [frames * channels]
  int64_t frames;
  int32_t channels;
  int32_t sample_rate;
};

static uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Returns 0 on success; fills `out` with malloc'd samples (caller frees via
// whisperx_free).
int whisperx_decode_wav(const char* path, DecodedAudio* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 44) {
    fclose(f);
    return -2;
  }
  std::vector<uint8_t> buf((size_t)size);
  if (fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    return -3;
  }
  fclose(f);

  const uint8_t* p = buf.data();
  if (memcmp(p, "RIFF", 4) != 0 || memcmp(p + 8, "WAVE", 4) != 0) return -4;

  uint16_t fmt_tag = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* data = nullptr;
  uint32_t data_size = 0;

  size_t pos = 12;
  while (pos + 8 <= (size_t)size) {
    const uint8_t* cid = p + pos;
    uint32_t csize = rd_u32(p + pos + 4);
    const uint8_t* body = p + pos + 8;
    if (pos + 8 + csize > (size_t)size) csize = (uint32_t)(size - pos - 8);
    if (memcmp(cid, "fmt ", 4) == 0 && csize >= 16) {
      fmt_tag = rd_u16(body);
      channels = rd_u16(body + 2);
      rate = rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (fmt_tag == 0xFFFE && csize >= 40) fmt_tag = rd_u16(body + 24);
    } else if (memcmp(cid, "data", 4) == 0) {
      data = body;
      data_size = csize;
    }
    pos += 8 + csize + (csize & 1);
  }
  if (!data || channels == 0 || rate == 0) return -5;

  int64_t n_samples = 0;
  if (fmt_tag == 1) {  // PCM
    int bytes = bits / 8;
    if (bits != 8 && bits != 16 && bits != 24 && bits != 32) return -6;
    n_samples = data_size / bytes;
  } else if (fmt_tag == 3) {  // IEEE float
    if (bits != 32 && bits != 64) return -6;
    n_samples = data_size / (bits / 8);
  } else {
    return -6;
  }

  float* samples = (float*)malloc(sizeof(float) * (size_t)n_samples);
  if (!samples) return -7;

  if (fmt_tag == 3 && bits == 32) {
    memcpy(samples, data, sizeof(float) * (size_t)n_samples);
  } else if (fmt_tag == 3 && bits == 64) {
    const double* d = (const double*)data;
    for (int64_t i = 0; i < n_samples; i++) samples[i] = (float)d[i];
  } else if (bits == 8) {
    for (int64_t i = 0; i < n_samples; i++)
      samples[i] = ((float)data[i] - 128.0f) / 128.0f;
  } else if (bits == 16) {
    const int16_t* d = (const int16_t*)data;
    for (int64_t i = 0; i < n_samples; i++) samples[i] = d[i] / 32768.0f;
  } else if (bits == 24) {
    for (int64_t i = 0; i < n_samples; i++) {
      const uint8_t* b = data + 3 * i;
      int32_t v = (int32_t)((uint32_t)b[0] | ((uint32_t)b[1] << 8) |
                            ((uint32_t)b[2] << 16));
      v = (v << 8) >> 8;  // sign extend
      samples[i] = (float)v / 8388608.0f;
    }
  } else {  // 32-bit PCM
    const int32_t* d = (const int32_t*)data;
    for (int64_t i = 0; i < n_samples; i++)
      samples[i] = (float)d[i] / 2147483648.0f;
  }

  out->samples = samples;
  out->frames = n_samples / channels;
  out->channels = channels;
  out->sample_rate = (int32_t)rate;
  return 0;
}

void whisperx_free(void* ptr) { free(ptr); }

// ---------------------------------------------------------------------------
// Polyphase resampler (Kaiser-windowed sinc, scipy resample_poly design)
// ---------------------------------------------------------------------------

static double bessel_i0(double x) {
  // Series expansion; converges fast for the beta range we use.
  double sum = 1.0, term = 1.0;
  double x2 = x * x / 4.0;
  for (int k = 1; k < 64; k++) {
    term *= x2 / (double)(k * k);
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

// Resample 1-D float32 audio by rational factor up/down.
// Output buffer is malloc'd into *out (caller frees); returns output length
// or a negative error.
int64_t whisperx_resample_poly(const float* x, int64_t n, int32_t up,
                               int32_t down, float** out) {
  if (up <= 0 || down <= 0 || n <= 0) return -1;
  if (up == down) {
    float* y = (float*)malloc(sizeof(float) * (size_t)n);
    if (!y) return -2;
    memcpy(y, x, sizeof(float) * (size_t)n);
    *out = y;
    return n;
  }

  // Filter design (matches scipy.signal.resample_poly defaults):
  // half_len = 10 * max(up, down), Kaiser beta 5.0, cutoff 1/max(up, down).
  const int64_t max_rate = (up > down) ? up : down;
  const double f_c = 1.0 / (double)max_rate;
  const int64_t half_len = 10 * max_rate;
  const int64_t taps = 2 * half_len + 1;
  const double beta = 5.0;

  std::vector<double> h((size_t)taps);
  const double i0b = bessel_i0(beta);
  double dc = 0.0;
  for (int64_t i = 0; i < taps; i++) {
    const double m = (double)(i - half_len);
    // sinc lowpass at f_c (normalized to Nyquist)
    double s = (m == 0.0) ? f_c : sin(M_PI * f_c * m) / (M_PI * m);
    // Kaiser window
    double r = 2.0 * (double)i / (double)(taps - 1) - 1.0;
    double w = bessel_i0(beta * sqrt(1.0 - r * r)) / i0b;
    h[(size_t)i] = s * w;
    dc += s * w;
  }
  // firwin(scale=True) parity: unit DC gain, then gain `up` for interpolation.
  for (int64_t i = 0; i < taps; i++) h[(size_t)i] *= (double)up / dc;

  // Output length per scipy: ceil(n * up / down).
  const int64_t n_out = (n * (int64_t)up + down - 1) / down;
  float* y = (float*)malloc(sizeof(float) * (size_t)n_out);
  if (!y) return -2;

  // Polyphase evaluation: y[j] corresponds to upsampled index j*down.
  // y[j] = sum_k h[t*up ... ] — evaluate directly against input samples:
  // upsampled position p = j*down; contributing input samples i satisfy
  // p - (i*up) within [-half_len, half_len].
  for (int64_t j = 0; j < n_out; j++) {
    const int64_t p = j * (int64_t)down;  // position in up-rate grid
    // input sample i contributes h[p - i*up + half_len]
    int64_t i_min = (p - half_len + up - 1) / up;  // ceil((p-half)/up)
    int64_t i_max = (p + half_len) / up;           // floor
    if (i_min < 0) i_min = 0;
    if (i_max >= n) i_max = n - 1;
    double acc = 0.0;
    for (int64_t i = i_min; i <= i_max; i++) {
      acc += (double)x[i] * h[(size_t)(p - i * up + half_len)];
    }
    y[j] = (float)acc;
  }

  *out = y;
  return n_out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Async ingest pool: decode + downmix + resample on background threads.
//
// The reference overlaps host data work with GPU compute via torch
// DataLoader worker processes (whisperx/asr.py:158-171); this is the
// framework's native equivalent for file ingest: a std::thread pool turning
// paths into mono 16 kHz float32 waveforms while the accelerator transcribes
// the previous file. Jobs are polled (non-blocking) or waited on; results
// are malloc'd buffers the caller frees with whisperx_free.
// ---------------------------------------------------------------------------

namespace {

struct IngestJob {
  std::string path;
  int32_t target_rate;
  int64_t id;
};

struct IngestDone {
  float* samples = nullptr;  // mono, target_rate
  int64_t n = 0;
  int status = -100;  // decode/resample rc
};

struct IngestPool {
  std::vector<std::thread> workers;
  std::deque<IngestJob> queue;
  std::unordered_map<int64_t, IngestDone> done;
  std::mutex mu;
  std::condition_variable cv_job;   // workers wait for jobs
  std::condition_variable cv_done;  // waiters wait for results
  int64_t next_id = 1;
  bool stopping = false;
};

// Full ingest for one file: decode -> mono -> resample. Returns 0 on ok.
int ingest_file(const char* path, int32_t target_rate, float** out,
                int64_t* n_out) {
  DecodedAudio dec;
  int rc = whisperx_decode_wav(path, &dec);
  if (rc != 0) return rc;

  float* mono = dec.samples;
  int64_t n = dec.frames;
  std::vector<float> mono_buf;
  if (dec.channels > 1) {
    mono_buf.resize((size_t)dec.frames);
    const float inv = 1.0f / (float)dec.channels;
    for (int64_t i = 0; i < dec.frames; i++) {
      double acc = 0.0;
      const float* f = dec.samples + i * dec.channels;
      for (int32_t c = 0; c < dec.channels; c++) acc += f[c];
      mono_buf[(size_t)i] = (float)acc * inv;
    }
    mono = mono_buf.data();
  }

  if (dec.sample_rate == target_rate) {
    float* y = (float*)malloc(sizeof(float) * (size_t)n);
    if (!y) {
      free(dec.samples);
      return -7;
    }
    memcpy(y, mono, sizeof(float) * (size_t)n);
    *out = y;
    *n_out = n;
    free(dec.samples);
    return 0;
  }

  // Rational factor target/orig reduced by gcd.
  int64_t a = target_rate, b = dec.sample_rate;
  while (b) {
    int64_t t = a % b;
    a = b;
    b = t;
  }
  const int32_t up = (int32_t)(target_rate / a);
  const int32_t down = (int32_t)(dec.sample_rate / a);
  float* y = nullptr;
  int64_t m = whisperx_resample_poly(mono, n, up, down, &y);
  free(dec.samples);
  if (m < 0) return (int)m;
  *out = y;
  *n_out = m;
  return 0;
}

void pool_worker(IngestPool* p) {
  for (;;) {
    IngestJob job;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_job.wait(lk, [p] { return p->stopping || !p->queue.empty(); });
      if (p->stopping && p->queue.empty()) return;
      job = p->queue.front();
      p->queue.pop_front();
    }
    IngestDone d;
    d.status = ingest_file(job.path.c_str(), job.target_rate, &d.samples, &d.n);
    {
      std::lock_guard<std::mutex> lk(p->mu);
      p->done[job.id] = d;
    }
    p->cv_done.notify_all();
  }
}

}  // namespace

extern "C" {

void* whisperx_pool_create(int32_t threads) {
  if (threads <= 0) threads = 2;
  if (threads > 64) threads = 64;
  IngestPool* p = new (std::nothrow) IngestPool();
  if (!p) return nullptr;
  for (int32_t i = 0; i < threads; i++) p->workers.emplace_back(pool_worker, p);
  return p;
}

int64_t whisperx_pool_submit(void* pool, const char* path, int32_t target_rate) {
  IngestPool* p = (IngestPool*)pool;
  int64_t id;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    id = p->next_id++;
    p->queue.push_back(IngestJob{path, target_rate, id});
  }
  p->cv_job.notify_one();
  return id;
}

// wait_ms < 0: block until done. Returns 0 done-ok (fills out/n, caller
// frees), 1 still pending, <0 the job's decode/resample error.
int32_t whisperx_pool_wait(void* pool, int64_t job_id, int32_t wait_ms,
                           float** out, int64_t* n_out) {
  IngestPool* p = (IngestPool*)pool;
  std::unique_lock<std::mutex> lk(p->mu);
  auto ready = [&] { return p->done.count(job_id) != 0; };
  if (wait_ms < 0) {
    p->cv_done.wait(lk, ready);
  } else if (!ready()) {
    p->cv_done.wait_for(lk, std::chrono::milliseconds(wait_ms), ready);
  }
  auto it = p->done.find(job_id);
  if (it == p->done.end()) return 1;
  IngestDone d = it->second;
  p->done.erase(it);
  if (d.status != 0) return d.status;
  *out = d.samples;
  *n_out = d.n;
  return 0;
}

void whisperx_pool_destroy(void* pool) {
  IngestPool* p = (IngestPool*)pool;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stopping = true;
  }
  p->cv_job.notify_all();
  for (auto& t : p->workers) t.join();
  for (auto& kv : p->done) free(kv.second.samples);
  delete p;
}

}  // extern "C"
