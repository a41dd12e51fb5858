// TimerManager: per-program timing records, stats, hang detection. The
// port's own copy of native/tpu_timer/timer_manager.h.
//
// Parity: reference xpu_timer GpuTimerManager (xpu_timer/common/manager.h:
// 106-197) -- event pool + worker thread computing latency and detecting a
// hang when the queue head exceeds a timeout. The manager takes tokens and
// knows no device: cuda_hook.cc's poller ends an execution once its CUDA
// end event has passed and hands it the device time between its two
// events. The worker thread only ages the pending set for hang detection,
// on the host clock from the call.
#ifndef DLROVER_TORCH_TIMER_MANAGER_H_
#define DLROVER_TORCH_TIMER_MANAGER_H_

#include <pthread.h>
#include <signal.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace dlrover_torch {

// A thread that blocks every signal: a signal sent to the process (the
// hang dumper's SIGUSR2) then lands in one of the program's own threads.
template <typename F>
std::thread StartQuietThread(F&& f) {
  sigset_t all, old;
  sigfillset(&all);
  pthread_sigmask(SIG_SETMASK, &all, &old);
  std::thread t(std::forward<F>(f));
  pthread_sigmask(SIG_SETMASK, &old, nullptr);
  return t;
}

struct TraceEvent {
  std::string name;
  const char* kind;  // "compile" | "execute"
  int64_t start_us;  // since manager start
  int64_t dur_us;
};

//: log2 latency buckets: upper bounds 64us << i (64us .. ~2.1s), last
//: bucket is +Inf. Fixed-size so recording is a shift + increment —
//: the reference exports brpc-bvar latency quantiles per kernel
//: (common/bvar_prometheus.cc); these buckets power the same
//: p50/p99 gauges plus a real Prometheus histogram series.
constexpr int kLatencyBuckets = 16;
constexpr int64_t kLatencyBase = 64;  // us

struct ProgramStats {
  uint64_t count = 0;
  uint64_t total_us = 0;
  uint64_t max_us = 0;
  uint64_t errors = 0;
  uint64_t lat_buckets[kLatencyBuckets] = {0};
  // Per-execution cost: a collective's bytes (cuda_hook.cc), the train
  // step's 6*params*tokens flops (the trainer, through the C API).
  double flops = 0;
  double bytes = 0;
  // EMA of achieved-flops / peak per completion (live MFU, 0..1);
  // only maintained when peak_tflops is configured.
  double util_ema = 0;
};

class TimerManager {
 public:
  static TimerManager& Get();

  // -- recording ------------------------------------------------------------
  void RecordCompile(const std::string& name, int64_t dur_us);
  // Attach compiler cost-analysis numbers to a program's timer record.
  void RegisterCost(const std::string& name, double flops, double bytes);
  // Returns a token identifying the pending execution.
  uint64_t BeginExecute(const std::string& name);
  // dur_us < 0: the host time since BeginExecute; otherwise the latency
  // measured elsewhere (the device time between two CUDA events).
  void EndExecute(uint64_t token, bool error, int64_t dur_us = -1);

  // -- introspection --------------------------------------------------------
  size_t PendingCount();
  bool HangDetected();
  // Oldest pending execution age in us (0 when none pending).
  int64_t OldestPendingUs();
  std::string PrometheusText();
  std::string TimelineJson();
  // Pending executions as JSON [{"name":..., "age_us":...}] — the hang
  // dump's "which kernels are stuck" list (reference printHangName,
  // manager.cc:454-464).
  std::string PendingJson();
  // Management surface (reference hosting_service StartDump/StopDump,
  // server/hosting_service_server_client.h:40-242): toggle trace-event
  // collection at runtime; Start clears the ring.
  void StartTrace();
  void StopTrace();
  bool Tracing() const { return tracing_.load(); }

  int64_t NowUs() const;

  // Test hook: shrink the hang timeout (normally from env
  // DLROVER_TPU_TIMER_HANG_SECS, default 300).
  void SetHangTimeoutUs(int64_t us) { hang_timeout_us_ = us; }
  // Test hook: per-program series cap (normally from env
  // DLROVER_TPU_TIMER_MAX_SERIES, default 32).
  void SetMaxSeries(size_t n) { max_series_ = n ? n : 1; }

 private:
  TimerManager();
  ~TimerManager();
  void WatchLoop();

  struct Pending {
    std::string name;
    int64_t start_us;
  };

  std::mutex mu_;
  std::unordered_map<uint64_t, Pending> pending_;
  std::unordered_map<std::string, ProgramStats> exec_stats_;
  std::unordered_map<std::string, ProgramStats> compile_stats_;
  std::deque<TraceEvent> trace_;  // bounded ring
  uint64_t next_token_ = 1;
  size_t trace_cap_ = 100000;

  // live MFU: peak from env DLROVER_TPU_TIMER_PEAK_TFLOPS (0 = unset,
  // per-program utilization then unavailable but flops/bytes still export)
  double peak_tflops_ = 0;
  size_t max_series_ = 32;  // per-program series cap (tail is bucketed)
  double device_flops_total_ = 0;  // sum of completed executions' flops
  // flops-weighted live MFU across programs: decayed numerator
  // (util*flops) over decayed denominator (flops), so a chatty tiny
  // program cannot drown out the train step's utilization
  double mfu_num_ = 0;
  double mfu_den_ = 0;

  std::atomic<bool> hang_{false};
  std::atomic<bool> tracing_{true};
  std::atomic<int64_t> hang_timeout_us_;
  std::atomic<bool> stop_{false};
  int64_t t0_ns_;
  std::thread watcher_;
};

}  // namespace dlrover_torch

#endif  // DLROVER_TORCH_TIMER_MANAGER_H_
