// Native host runtime: WAV codec + serial CPU moving averager + bench CLI.
//
// The reference's native layer is C++/CUDA (wav_header.h, benchmark.h,
// profilable_moving_averager.cpp). This framework keeps the host-native
// pieces native: this file provides
//   - a canonical 44-byte PCM WAV reader/writer (16-bit only, rejecting
//     8/24/32/64-bit like wav_header.h:34-37),
//   - the golden serial sliding-sum averager (ramp-up divides by the full
//     window; int64 accumulators; C truncating division — the semantics of
//     profilable_moving_averager.cpp:14-37, with the missing-brace defect
//     fixed per SURVEY.md §7),
//   - a warmup-then-average wall-clock bench loop (benchmark.h:116-132
//     protocol: 5 warmup + 10 measured rounds),
// exposed through an extern "C" ABI for the Python ctypes wrapper
// (digital_signal_processsing_tpu/io/native.py) and through the standalone
// CLI `dsp_cpu_bench <wav_path> <grade> <block_size>` mirroring the
// reference binaries' argv contract.
//
// Build: make -C native   (produces libdsp_native.so and dsp_cpu_bench)

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

#pragma pack(push, 1)
struct WavHeader {
  char riff[4];
  uint32_t size_of_file;
  char wave[4];
  char fmt[4];
  uint32_t fmt_size;
  uint16_t audio_format;
  uint16_t num_channels;
  uint32_t sample_rate;
  uint32_t byte_rate;
  uint16_t block_align;
  uint16_t bits_per_sample;
  char data[4];
  uint32_t data_bytes;
};
#pragma pack(pop)
static_assert(sizeof(WavHeader) == 44, "canonical header must be 44 bytes");

bool header_ok(const WavHeader& h) {
  return std::memcmp(h.riff, "RIFF", 4) == 0 &&
         std::memcmp(h.wave, "WAVE", 4) == 0 &&
         std::memcmp(h.fmt, "fmt ", 4) == 0 &&
         std::memcmp(h.data, "data", 4) == 0 && h.audio_format == 1 &&
         h.bits_per_sample == 16 &&  // reject 8/24/32/64 like wav_header.h:34-37
         h.num_channels >= 1;        // a zero channel count would SIGFPE below
}

int64_t trunc_div(int64_t num, int64_t den) { return num / den; }  // C trunc

}  // namespace

extern "C" {

// Reads header only; returns 0 on success. Outputs channels/rate/samples.
int dsp_wav_info(const char* path, int32_t* channels, int32_t* sample_rate,
                 int64_t* num_samples) {
  std::ifstream in(path, std::ios::binary);
  if (!in) return 1;
  WavHeader h;
  in.read(reinterpret_cast<char*>(&h), sizeof(h));
  if (!in || !header_ok(h)) return 2;
  *channels = h.num_channels;
  *sample_rate = h.sample_rate;
  *num_samples = h.data_bytes / 2;
  return 0;
}

// Reads up to max_samples int16 samples into out. Returns count read, or <0.
int64_t dsp_wav_read(const char* path, int16_t* out, int64_t max_samples) {
  std::ifstream in(path, std::ios::binary);
  if (!in) return -1;
  WavHeader h;
  in.read(reinterpret_cast<char*>(&h), sizeof(h));
  if (!in || !header_ok(h)) return -2;
  int64_t n = h.data_bytes / 2;
  if (n > max_samples) n = max_samples;
  in.read(reinterpret_cast<char*>(out), n * 2);
  return in.gcount() / 2;
}

// Writes a canonical 16-bit PCM WAV. Returns 0 on success.
int dsp_wav_write(const char* path, const int16_t* samples,
                  int64_t num_samples, int32_t sample_rate,
                  int32_t channels) {
  if (channels < 1 || num_samples % channels != 0) return 3;
  std::ofstream out(path, std::ios::binary);
  if (!out) return 1;
  WavHeader h;
  std::memcpy(h.riff, "RIFF", 4);
  std::memcpy(h.wave, "WAVE", 4);
  std::memcpy(h.fmt, "fmt ", 4);
  std::memcpy(h.data, "data", 4);
  h.fmt_size = 16;
  h.audio_format = 1;
  h.num_channels = static_cast<uint16_t>(channels);
  h.sample_rate = static_cast<uint32_t>(sample_rate);
  h.bits_per_sample = 16;
  h.byte_rate = h.sample_rate * channels * 2;
  h.block_align = static_cast<uint16_t>(channels * 2);
  h.data_bytes = static_cast<uint32_t>(num_samples * 2);
  h.size_of_file = 36 + h.data_bytes;
  out.write(reinterpret_cast<const char*>(&h), sizeof(h));
  out.write(reinterpret_cast<const char*>(samples), num_samples * 2);
  return out ? 0 : 2;
}

// Threaded batch reader: decode n files concurrently into one buffer.
// offsets[i] is the destination sample offset of file i (caller computes
// from dsp_wav_info); counts[i] its expected sample count. Returns the
// number of files read successfully.
int dsp_wav_read_many(const char** paths, int32_t n, int16_t* out,
                      const int64_t* offsets, const int64_t* counts,
                      int32_t num_threads) {
  if (n <= 0) return 0;
  if (num_threads < 1) num_threads = 1;
  std::atomic<int32_t> next{0};
  std::atomic<int32_t> ok{0};
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      int64_t got = dsp_wav_read(paths[i], out + offsets[i], counts[i]);
      if (got == counts[i]) ok.fetch_add(1);
    }
  };
  int32_t t = num_threads < n ? num_threads : n;
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int32_t i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok.load();
}

// Golden serial moving averager over an interleaved int16 stream.
// Semantics of profilable_moving_averager.cpp:14-37: per-channel int64
// sliding sums, ramp-up divides by the FULL window, truncating division.
void dsp_moving_average(const int16_t* in, int16_t* out, int64_t num_samples,
                        int32_t channels, int32_t window) {
  const int64_t frames = num_samples / channels;
  std::vector<int64_t> sums(channels, 0);
  const int64_t ramp = window < frames ? window : frames;
  for (int64_t f = 0; f < ramp; ++f) {
    for (int32_t c = 0; c < channels; ++c) {
      sums[c] += in[f * channels + c];
      out[f * channels + c] =
          static_cast<int16_t>(trunc_div(sums[c], window));
    }
  }
  for (int64_t f = window; f < frames; ++f) {
    for (int32_t c = 0; c < channels; ++c) {
      sums[c] += in[f * channels + c] - in[(f - window) * channels + c];
      out[f * channels + c] =
          static_cast<int16_t>(trunc_div(sums[c], window));
    }
  }
}

// Warmup-then-average bench of the averager (benchmark.h:116-132 protocol).
// Returns mean milliseconds per measured round.
double dsp_bench_moving_average(const int16_t* in, int16_t* out,
                                int64_t num_samples, int32_t channels,
                                int32_t window, int32_t warmup,
                                int32_t rounds) {
  for (int32_t i = 0; i < warmup; ++i)
    dsp_moving_average(in, out, num_samples, channels, window);
  auto t0 = std::chrono::steady_clock::now();
  for (int32_t i = 0; i < rounds; ++i)
    dsp_moving_average(in, out, num_samples, channels, window);
  auto t1 = std::chrono::steady_clock::now();
  volatile int16_t sink = out[num_samples - 1];  // defeat DCE
  (void)sink;
  return std::chrono::duration<double, std::milli>(t1 - t0).count() /
         (rounds > 0 ? rounds : 1);
}

}  // extern "C"

// --- streaming executor -----------------------------------------------------
//
// The native serving runtime around serve.py: a background decode thread
// fills a bounded ring of fixed-size chunks from a list of WAVs treated as
// one concatenated stream (the C++ WavChunkLoader+prefetch), and a
// background encode thread drains a bounded queue into a streaming WAV
// sink (header patched on close, like io/wav.py's WavWriter). Host decode/
// encode runs off the GIL in native threads; the Python side only moves
// chunk buffers and drives the device.

namespace {

struct DspStream {
  std::vector<std::string> paths;
  int64_t chunk_samples = 0;
  size_t depth = 4;
  std::deque<std::vector<int16_t>> ring;  // decoded chunks
  std::deque<int64_t> counts;             // valid samples per chunk
  std::mutex mu;
  std::condition_variable can_produce, can_consume;
  bool done = false, stop = false;
  int error = 0;  // nonzero: decode failure
  std::thread worker;
};

void stream_worker(DspStream* s) {
  std::vector<int16_t> buf;
  buf.reserve(s->chunk_samples);
  auto flush = [&](int64_t valid) {
    // zero-pad the final partial chunk (loader contract); valid tells the
    // consumer how many samples are real
    buf.resize(s->chunk_samples, 0);
    std::unique_lock<std::mutex> lk(s->mu);
    s->can_produce.wait(
        lk, [&] { return s->ring.size() < s->depth || s->stop; });
    if (s->stop) return false;
    s->ring.push_back(std::move(buf));
    s->counts.push_back(valid);
    buf.clear();
    buf.reserve(s->chunk_samples);
    s->can_consume.notify_one();
    return true;
  };
  for (const auto& p : s->paths) {
    std::ifstream in(p, std::ios::binary);
    WavHeader h{};
    in.read(reinterpret_cast<char*>(&h), sizeof(h));
    if (!in.good() || !header_ok(h)) {
      std::lock_guard<std::mutex> lk(s->mu);
      s->error = 1;
      s->done = true;
      s->can_consume.notify_all();
      return;
    }
    // clamp to the body actually present (truncated-file guard, serve.py)
    in.seekg(0, std::ios::end);
    int64_t body = static_cast<int64_t>(in.tellg()) - 44;
    if (body < 0) body = 0;
    in.seekg(44, std::ios::beg);
    int64_t remaining = static_cast<int64_t>(h.data_bytes / 2);
    if (body / 2 < remaining) remaining = body / 2;
    while (remaining > 0) {
      int64_t want = s->chunk_samples - static_cast<int64_t>(buf.size());
      int64_t take = want < remaining ? want : remaining;
      size_t off = buf.size();
      buf.resize(off + take);
      in.read(reinterpret_cast<char*>(buf.data() + off), take * 2);
      if (!in.good()) {
        std::lock_guard<std::mutex> lk(s->mu);
        s->error = 2;
        s->done = true;
        s->can_consume.notify_all();
        return;
      }
      remaining -= take;
      if (static_cast<int64_t>(buf.size()) == s->chunk_samples) {
        if (!flush(s->chunk_samples)) return;
      }
    }
  }
  if (!buf.empty()) {
    int64_t valid = static_cast<int64_t>(buf.size());
    if (!flush(valid)) return;
  }
  std::lock_guard<std::mutex> lk(s->mu);
  s->done = true;
  s->can_consume.notify_all();
}

struct DspSink {
  std::FILE* f = nullptr;
  int32_t rate = 0, channels = 0;
  int64_t samples = 0;
  size_t depth = 4;
  std::deque<std::vector<int16_t>> q;
  std::mutex mu;
  std::condition_variable can_push, can_pop;
  bool closing = false;
  int error = 0;
  std::thread worker;
};

void write_header(std::FILE* f, int32_t rate, int32_t channels,
                  int64_t samples) {
  WavHeader h{};
  std::memcpy(h.riff, "RIFF", 4);
  std::memcpy(h.wave, "WAVE", 4);
  std::memcpy(h.fmt, "fmt ", 4);
  std::memcpy(h.data, "data", 4);
  h.fmt_size = 16;
  h.audio_format = 1;
  h.num_channels = static_cast<uint16_t>(channels);
  h.sample_rate = static_cast<uint32_t>(rate);
  h.byte_rate = static_cast<uint32_t>(rate * channels * 2);
  h.block_align = static_cast<uint16_t>(channels * 2);
  h.bits_per_sample = 16;
  h.data_bytes = static_cast<uint32_t>(samples * 2);
  h.size_of_file = 36 + h.data_bytes;
  std::fwrite(&h, sizeof(h), 1, f);
}

void sink_worker(DspSink* s) {
  for (;;) {
    std::vector<int16_t> buf;
    {
      std::unique_lock<std::mutex> lk(s->mu);
      s->can_pop.wait(lk, [&] { return !s->q.empty() || s->closing; });
      if (s->q.empty()) return;  // closing and drained
      buf = std::move(s->q.front());
      s->q.pop_front();
      s->can_push.notify_one();
    }
    if (std::fwrite(buf.data(), 2, buf.size(), s->f) != buf.size()) {
      std::lock_guard<std::mutex> lk(s->mu);
      s->error = 1;
      // wake any producer blocked on a full queue so it can observe the
      // error (the wait predicate below includes s->error) instead of
      // hanging forever after e.g. a disk-full mid-stream
      s->can_push.notify_all();
      return;
    }
  }
}

}  // namespace

extern "C" {

// Open a chunked reader over n WAVs as one stream. Returns a handle or
// nullptr. Channel/rate consistency is the caller's check (headers via
// dsp_wav_info); decode errors surface as a negative dsp_stream_next.
void* dsp_stream_open(const char** paths, int32_t n_paths,
                      int64_t chunk_samples, int32_t depth) {
  if (n_paths <= 0 || chunk_samples <= 0) return nullptr;
  auto* s = new DspStream();
  for (int32_t i = 0; i < n_paths; ++i) s->paths.emplace_back(paths[i]);
  s->chunk_samples = chunk_samples;
  s->depth = depth > 0 ? static_cast<size_t>(depth) : 4;
  s->worker = std::thread(stream_worker, s);
  return s;
}

// Copy the next chunk into out (chunk_samples int16, zero-padded tail).
// Returns valid sample count, 0 at end of stream, <0 on decode error.
int64_t dsp_stream_next(void* handle, int16_t* out) {
  auto* s = static_cast<DspStream*>(handle);
  std::unique_lock<std::mutex> lk(s->mu);
  s->can_consume.wait(lk, [&] { return !s->ring.empty() || s->done; });
  if (s->ring.empty()) return s->error ? -s->error : 0;
  std::vector<int16_t> buf = std::move(s->ring.front());
  int64_t valid = s->counts.front();
  s->ring.pop_front();
  s->counts.pop_front();
  s->can_produce.notify_one();
  lk.unlock();
  std::memcpy(out, buf.data(), buf.size() * 2);
  return valid;
}

void dsp_stream_close(void* handle) {
  auto* s = static_cast<DspStream*>(handle);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->stop = true;
    s->can_produce.notify_all();
  }
  if (s->worker.joinable()) s->worker.join();
  delete s;
}

// Open a streaming WAV sink (background encode thread, bounded queue).
void* dsp_sink_open(const char* path, int32_t sample_rate, int32_t channels,
                    int32_t depth) {
  if (channels < 1) return nullptr;
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  auto* s = new DspSink();
  s->f = f;
  s->rate = sample_rate;
  s->channels = channels;
  s->depth = depth > 0 ? static_cast<size_t>(depth) : 4;
  write_header(f, sample_rate, channels, 0);
  s->worker = std::thread(sink_worker, s);
  return s;
}

// Queue n samples for writing (copies; blocks when the queue is full).
// Returns 0, or <0 after a write error.
int dsp_sink_append(void* handle, const int16_t* samples, int64_t n) {
  auto* s = static_cast<DspSink*>(handle);
  if (n < 0 || n % s->channels != 0) return -2;
  std::unique_lock<std::mutex> lk(s->mu);
  if (s->error) return -1;
  s->can_push.wait(lk, [&] { return s->q.size() < s->depth || s->error; });
  if (s->error) return -1;
  s->q.emplace_back(samples, samples + n);
  s->samples += n;
  s->can_pop.notify_one();
  return 0;
}

// Drain, patch the header sizes, close. Returns total samples or <0.
int64_t dsp_sink_close(void* handle) {
  auto* s = static_cast<DspSink*>(handle);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->closing = true;
    s->can_pop.notify_all();
  }
  if (s->worker.joinable()) s->worker.join();
  int64_t total = s->error ? -1 : s->samples;
  std::fseek(s->f, 0, SEEK_SET);
  write_header(s->f, s->rate, s->channels, s->samples);
  std::fclose(s->f);
  delete s;
  return total;
}

}  // extern "C"

#ifdef DSP_NATIVE_MAIN
// CLI mirroring the reference binaries: <wav_path> <grade> <block_size>.
// block_size is accepted for argv compatibility (validated like
// profilable_moving_averager.cpp:94-97) but has no meaning on the host path.
int main(int argc, char** argv) {
  if (argc < 4) {
    std::fprintf(stderr, "Usage: %s <wav_path> <grade> <block_size>\n",
                 argv[0]);
    return 1;
  }
  const char* path = argv[1];
  const int window = std::atoi(argv[2]);
  const int block = std::atoi(argv[3]);
  if (block < 32 || block > 1024 || block % 32 != 0) {
    std::fprintf(stderr, "Error: Block size must be multiple of 32\n");
    return 1;
  }
  if (window < 1) {
    std::fprintf(stderr, "Error: grade must be >= 1\n");
    return 1;
  }
  int32_t channels = 0, rate = 0;
  int64_t n = 0;
  if (dsp_wav_info(path, &channels, &rate, &n) != 0 || n <= 0) {
    std::fprintf(stderr, "Error: could not read %s\n", path);
    return 1;
  }
  std::vector<int16_t> in(n), out(n);
  if (dsp_wav_read(path, in.data(), n) != n) {
    std::fprintf(stderr, "Error: short read from %s\n", path);
    return 1;
  }
  const double ms =
      dsp_bench_moving_average(in.data(), out.data(), n, channels, window,
                               /*warmup=*/5, /*rounds=*/10);
  std::printf("--- native serial averager ---\n");
  std::printf("total samples: %lld\n", static_cast<long long>(n));
  std::printf("window: %d\n", window);
  std::printf("compute: %.3f ms  (%.3f MSamples/s)\n", ms,
              n / ms / 1e3);
  return 0;
}
#endif
