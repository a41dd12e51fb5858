// A stand-in for libcuda.so.1 (built with that soname) for the CPU tests
// of cuda_hook.cc: no card, only the driver entry points the hook uses.
//
// Each stream keeps a device clock: the host time, in microseconds, when
// the work queued on it ends. mock_cuda_enqueue(stream, us) queues `us` of
// device work (us < 0: work that never ends); an event recorded on a
// stream passes when the stream's queued work has ended, and the elapsed
// time between two events is the difference of their device times, not
// the host time of the query. mock_cuda_set_capturing(stream) makes a
// stream report an active graph capture.

#include <time.h>

#include <cstdint>
#include <limits>
#include <map>
#include <mutex>

namespace {

constexpr int64_t kNever = std::numeric_limits<int64_t>::max();

struct Event {
  int64_t done_us = -1;  // -1: not recorded
};

std::mutex mu;
std::map<void*, int64_t> busy_until;  // stream -> device clock
void* capturing = reinterpret_cast<void*>(-1);

int64_t NowUs() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1000000LL + ts.tv_nsec / 1000;
}

}  // namespace

extern "C" {

int cuCtxGetCurrent(void** ctx) {
  *ctx = reinterpret_cast<void*>(0x1);
  return 0;
}

int cuCtxSetCurrent(void*) { return 0; }

int cuThreadExchangeStreamCaptureMode(int* mode) {
  *mode = 0;
  return 0;
}

int cuStreamIsCapturing(void* stream, int* status) {
  std::lock_guard<std::mutex> lock(mu);
  *status = stream == capturing ? 1 : 0;
  return 0;
}

int cuEventCreate(void** event, unsigned) {
  *event = new Event();
  return 0;
}

int cuEventRecord(void* event, void* stream) {
  std::lock_guard<std::mutex> lock(mu);
  int64_t now = NowUs();
  int64_t& busy = busy_until[stream];
  static_cast<Event*>(event)->done_us = busy > now ? busy : now;
  return 0;
}

int cuEventQuery(void* event) {
  int64_t done = static_cast<Event*>(event)->done_us;
  return done >= 0 && done != kNever && NowUs() >= done ? 0 : 600;
}

int cuEventElapsedTime(float* ms, void* start, void* end) {
  int64_t a = static_cast<Event*>(start)->done_us;
  int64_t b = static_cast<Event*>(end)->done_us;
  if (a < 0 || b < 0 || b == kNever) return 600;
  *ms = static_cast<float>((b - a) / 1000.0);
  return 0;
}

int cuEventDestroy_v2(void* event) {
  delete static_cast<Event*>(event);
  return 0;
}

void mock_cuda_enqueue(void* stream, int64_t us) {
  std::lock_guard<std::mutex> lock(mu);
  int64_t now = NowUs();
  int64_t& busy = busy_until[stream];
  if (busy == kNever) return;
  if (us < 0) {
    busy = kNever;
    return;
  }
  busy = (busy > now ? busy : now) + us;
}

void mock_cuda_set_capturing(void* stream) {
  std::lock_guard<std::mutex> lock(mu);
  capturing = stream;
}

}  // extern "C"
