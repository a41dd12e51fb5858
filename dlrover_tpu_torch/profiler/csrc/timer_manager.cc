// The port's own copy of native/tpu_timer/timer_manager.cc; EndExecute
// takes a latency measured on the device.
#include "timer_manager.h"

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <ctime>
#include <map>
#include <sstream>
#include <utility>
#include <vector>

namespace dlrover_torch {

static int64_t MonotonicNs() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

TimerManager& TimerManager::Get() {
  static TimerManager* mgr = new TimerManager();  // leaked: outlive plugin
  return *mgr;
}

TimerManager::TimerManager() : t0_ns_(MonotonicNs()) {
  const char* env = std::getenv("DLROVER_TPU_TIMER_HANG_SECS");
  int64_t secs = env ? std::atoll(env) : 300;
  if (secs <= 0) secs = 300;
  hang_timeout_us_ = secs * 1000000LL;
  const char* peak = std::getenv("DLROVER_TPU_TIMER_PEAK_TFLOPS");
  peak_tflops_ = peak ? std::atof(peak) : 0.0;
  // Cardinality cap (reference bvar_prometheus.cc:1-232 buckets series
  // by throughput level for the same reason): per-program series are
  // kept for the top-N programs by total device time; the long tail is
  // aggregated into flops-magnitude buckets.
  const char* max_series = std::getenv("DLROVER_TPU_TIMER_MAX_SERIES");
  max_series_ = max_series ? (size_t)std::atoll(max_series) : 32;
  if (max_series_ == 0) max_series_ = 32;
  watcher_ = StartQuietThread([this] { WatchLoop(); });
}

TimerManager::~TimerManager() {
  stop_ = true;
  if (watcher_.joinable()) watcher_.join();
}

int64_t TimerManager::NowUs() const { return (MonotonicNs() - t0_ns_) / 1000; }

void TimerManager::RecordCompile(const std::string& name, int64_t dur_us) {
  std::lock_guard<std::mutex> lock(mu_);
  auto& s = compile_stats_[name];
  s.count++;
  s.total_us += dur_us;
  if ((uint64_t)dur_us > s.max_us) s.max_us = dur_us;
  if (tracing_.load()) {
    trace_.push_back({name, "compile", NowUs() - dur_us, dur_us});
    if (trace_.size() > trace_cap_) trace_.pop_front();
  }
}

void TimerManager::RegisterCost(const std::string& name, double flops,
                                double bytes) {
  if (flops <= 0 && bytes <= 0) return;
  std::lock_guard<std::mutex> lock(mu_);
  auto& s = exec_stats_[name];
  s.flops = flops;
  s.bytes = bytes;
}

uint64_t TimerManager::BeginExecute(const std::string& name) {
  std::lock_guard<std::mutex> lock(mu_);
  uint64_t token = next_token_++;
  pending_[token] = {name, NowUs()};
  return token;
}

void TimerManager::EndExecute(uint64_t token, bool error, int64_t dur_us) {
  std::lock_guard<std::mutex> lock(mu_);
  auto it = pending_.find(token);
  if (it == pending_.end()) return;
  int64_t dur = dur_us >= 0 ? dur_us : NowUs() - it->second.start_us;
  auto& s = exec_stats_[it->second.name];
  s.count++;
  s.total_us += dur;
  if ((uint64_t)dur > s.max_us) s.max_us = dur;
  if (error) s.errors++;
  int bucket = 0;
  while (bucket < kLatencyBuckets - 1 &&
         dur > (kLatencyBase << bucket))
    bucket++;
  s.lat_buckets[bucket]++;
  if (!error && s.flops > 0 && dur > 0) {
    device_flops_total_ += s.flops;
    if (peak_tflops_ > 0) {
      // achieved TFLOP/s of this completion vs peak -> live MFU sample
      double util = (s.flops / dur) / 1e6 / peak_tflops_;
      s.util_ema = s.util_ema == 0 ? util : 0.8 * s.util_ema + 0.2 * util;
      mfu_num_ = 0.8 * mfu_num_ + 0.2 * util * s.flops;
      mfu_den_ = 0.8 * mfu_den_ + 0.2 * s.flops;
    }
  }
  if (tracing_.load()) {
    trace_.push_back({it->second.name, "execute", it->second.start_us, dur});
    if (trace_.size() > trace_cap_) trace_.pop_front();
  }
  pending_.erase(it);
  if (pending_.empty()) hang_ = false;
}

size_t TimerManager::PendingCount() {
  std::lock_guard<std::mutex> lock(mu_);
  return pending_.size();
}

int64_t TimerManager::OldestPendingUs() {
  std::lock_guard<std::mutex> lock(mu_);
  int64_t now = NowUs();
  int64_t oldest = 0;
  for (const auto& kv : pending_) {
    int64_t age = now - kv.second.start_us;
    if (age > oldest) oldest = age;
  }
  return oldest;
}

bool TimerManager::HangDetected() { return hang_.load(); }

void TimerManager::WatchLoop() {
  // Reference doHang (manager.cc:393-414): the queue head aging past the
  // timeout flags a hang; we additionally log the pending programs once.
  bool reported = false;
  while (!stop_) {
    struct timespec ts = {0, 200 * 1000000};  // 200ms
    nanosleep(&ts, nullptr);
    int64_t oldest = OldestPendingUs();
    if (oldest > hang_timeout_us_.load()) {
      hang_ = true;
      if (!reported) {
        reported = true;
        std::lock_guard<std::mutex> lock(mu_);
        fprintf(stderr,
                "[dlrover_torch_timer] HANG: %zu executions pending, oldest "
                "%.1fs; pending programs:\n",
                pending_.size(), oldest / 1e6);
        for (const auto& kv : pending_)
          fprintf(stderr, "[dlrover_torch_timer]   %s (%.1fs)\n",
                  kv.second.name.c_str(),
                  (NowUs() - kv.second.start_us) / 1e6);
      }
    } else if (hang_ && oldest == 0) {
      hang_ = false;
      reported = false;
    }
  }
}

// Bucket-interpolated quantile in us (upper-bound linear within bucket).
static int64_t Quantile(const ProgramStats& s, double q) {
  if (s.count == 0) return 0;
  uint64_t target = (uint64_t)(q * s.count);
  if (target >= s.count) target = s.count - 1;
  uint64_t cum = 0;
  for (int i = 0; i < kLatencyBuckets; i++) {
    cum += s.lat_buckets[i];
    if (target < cum) {
      int64_t hi = kLatencyBase << i;
      if (i == kLatencyBuckets - 1) return (int64_t)s.max_us;
      int64_t lo = i == 0 ? 0 : (kLatencyBase << (i - 1));
      uint64_t in_bucket = s.lat_buckets[i];
      uint64_t rank = target - (cum - in_bucket);
      return lo + (hi - lo) * (int64_t)(rank + 1) / (int64_t)in_bucket;
    }
  }
  return (int64_t)s.max_us;
}

static void AppendOneStat(std::ostringstream& out, const char* metric,
                          const char* label_key, const std::string& label,
                          const ProgramStats& s) {
  out << metric << "_total{" << label_key << "=\"" << label << "\"} "
      << s.count << "\n";
  out << metric << "_us_sum{" << label_key << "=\"" << label << "\"} "
      << s.total_us << "\n";
  out << metric << "_us_max{" << label_key << "=\"" << label << "\"} "
      << s.max_us << "\n";
  if (s.errors)
    out << metric << "_errors{" << label_key << "=\"" << label << "\"} "
        << s.errors << "\n";
}

// Throughput-level bucket label for a tail program: the order of
// magnitude of its per-execution flops ("flops_1e12"), "flops_none"
// when the cost analysis gave nothing. Matches the reference's
// throughput-level series bucketing (bvar_prometheus.cc) in spirit:
// cardinality is bounded by the ~15 possible magnitudes, while
// similar-sized programs aggregate together meaningfully.
static std::string FlopsBucket(const ProgramStats& s) {
  if (s.flops <= 0) return "flops_none";
  int mag = (int)std::floor(std::log10(s.flops));
  std::ostringstream b;
  b << "flops_1e" << mag;
  return b.str();
}

static void MergeStats(ProgramStats& dst, const ProgramStats& s) {
  dst.count += s.count;
  dst.total_us += s.total_us;
  if (s.max_us > dst.max_us) dst.max_us = s.max_us;
  dst.errors += s.errors;
  for (int i = 0; i < kLatencyBuckets; i++)
    dst.lat_buckets[i] += s.lat_buckets[i];
  dst.flops += s.flops;
  dst.bytes += s.bytes;
}

// Partition stats into the per-program head (top max_series by total
// device time) and a flops-magnitude-bucketed tail.
static void SplitByCardinality(
    const std::unordered_map<std::string, ProgramStats>& stats,
    size_t max_series,
    std::vector<std::pair<std::string, const ProgramStats*>>* head,
    std::map<std::string, ProgramStats>* tail) {
  head->clear();
  tail->clear();
  if (stats.size() <= max_series) {
    for (const auto& kv : stats) head->emplace_back(kv.first, &kv.second);
    return;
  }
  std::vector<std::pair<std::string, const ProgramStats*>> order;
  order.reserve(stats.size());
  for (const auto& kv : stats) order.emplace_back(kv.first, &kv.second);
  std::sort(order.begin(), order.end(),
            [](const auto& a, const auto& b) {
              return a.second->total_us > b.second->total_us;
            });
  for (size_t i = 0; i < order.size(); i++) {
    if (i < max_series) {
      head->push_back(order[i]);
    } else {
      MergeStats((*tail)[FlopsBucket(*order[i].second)], *order[i].second);
    }
  }
}

std::string TimerManager::PrometheusText() {
  std::lock_guard<std::mutex> lock(mu_);
  std::ostringstream out;
  out << "# dlrover_tpu_timer metrics\n";
  out << "dlrover_tpu_timer_uptime_us " << NowUs() << "\n";
  out << "dlrover_tpu_timer_pending " << pending_.size() << "\n";
  out << "dlrover_tpu_timer_hang " << (hang_ ? 1 : 0) << "\n";
  int64_t now = NowUs();
  int64_t oldest = 0;
  for (const auto& kv : pending_) {
    int64_t age = now - kv.second.start_us;
    if (age > oldest) oldest = age;
  }
  out << "dlrover_tpu_timer_oldest_pending_us " << oldest << "\n";
  out << "dlrover_tpu_timer_device_flops_total " << device_flops_total_
      << "\n";
  if (peak_tflops_ > 0) {
    out << "dlrover_tpu_timer_peak_tflops " << peak_tflops_ << "\n";
    out << "dlrover_tpu_timer_mfu "
        << (mfu_den_ > 0 ? mfu_num_ / mfu_den_ : 0.0) << "\n";
  }
  // Cardinality-capped per-program series: head by device time, tail
  // aggregated into throughput-level buckets (reference
  // bvar_prometheus.cc series bucketing).
  std::vector<std::pair<std::string, const ProgramStats*>> exec_head;
  std::map<std::string, ProgramStats> exec_tail;
  SplitByCardinality(exec_stats_, max_series_, &exec_head, &exec_tail);
  std::vector<std::pair<std::string, const ProgramStats*>> comp_head;
  std::map<std::string, ProgramStats> comp_tail;
  SplitByCardinality(compile_stats_, max_series_, &comp_head, &comp_tail);
  for (const auto& kv : exec_head)
    AppendOneStat(out, "dlrover_tpu_timer_execute", "program", kv.first,
                  *kv.second);
  for (const auto& kv : exec_tail)
    AppendOneStat(out, "dlrover_tpu_timer_execute", "bucket", kv.first,
                  kv.second);
  for (const auto& kv : comp_head)
    AppendOneStat(out, "dlrover_tpu_timer_compile", "program", kv.first,
                  *kv.second);
  for (const auto& kv : comp_tail)
    AppendOneStat(out, "dlrover_tpu_timer_compile", "bucket", kv.first,
                  kv.second);
  if (!exec_tail.empty())
    out << "dlrover_tpu_timer_bucketed_programs "
        << (exec_stats_.size() > max_series_
                ? exec_stats_.size() - max_series_
                : 0)
        << "\n";

  // Prometheus histogram + quantile gauges per program (reference:
  // per-kernel bvar latency quantiles, common/bvar_prometheus.cc) —
  // head per-program, tail per-bucket
  auto emit_hist = [&](const char* label_key, const std::string& label,
                       const ProgramStats& s) {
    if (s.count == 0) return;
    uint64_t cum = 0;
    for (int i = 0; i < kLatencyBuckets; i++) {
      cum += s.lat_buckets[i];
      out << "dlrover_tpu_timer_execute_latency_us_bucket{" << label_key
          << "=\"" << label << "\",le=\"";
      if (i == kLatencyBuckets - 1)
        out << "+Inf";
      else
        out << (kLatencyBase << i);
      out << "\"} " << cum << "\n";
    }
    out << "dlrover_tpu_timer_execute_latency_us_count{" << label_key
        << "=\"" << label << "\"} " << s.count << "\n";
    out << "dlrover_tpu_timer_execute_latency_us_sum{" << label_key
        << "=\"" << label << "\"} " << s.total_us << "\n";
    out << "dlrover_tpu_timer_execute_latency_us_p50{" << label_key
        << "=\"" << label << "\"} " << Quantile(s, 0.50) << "\n";
    out << "dlrover_tpu_timer_execute_latency_us_p99{" << label_key
        << "=\"" << label << "\"} " << Quantile(s, 0.99) << "\n";
  };
  for (const auto& kv : exec_head) emit_hist("program", kv.first, *kv.second);
  for (const auto& kv : exec_tail) emit_hist("bucket", kv.first, kv.second);
  for (const auto& kv : exec_head) {
    const auto& s = *kv.second;
    if (s.flops <= 0 && s.bytes <= 0) continue;
    out << "dlrover_tpu_timer_program_flops{program=\"" << kv.first << "\"} "
        << s.flops << "\n";
    out << "dlrover_tpu_timer_program_bytes{program=\"" << kv.first << "\"} "
        << s.bytes << "\n";
    if (peak_tflops_ > 0 && s.util_ema > 0)
      out << "dlrover_tpu_timer_program_utilization{program=\"" << kv.first
          << "\"} " << s.util_ema << "\n";
  }
  return out.str();
}

static void JsonEscape(std::ostringstream& out, const std::string& s) {
  for (char c : s) {
    if (c == '"' || c == '\\')
      out << '\\' << c;
    else if ((unsigned char)c < 0x20)
      out << ' ';
    else
      out << c;
  }
}

std::string TimerManager::PendingJson() {
  std::lock_guard<std::mutex> lock(mu_);
  std::ostringstream out;
  int64_t now = NowUs();
  out << "{\"hang\":" << (hang_ ? "true" : "false") << ",\"pending\":[";
  bool first = true;
  for (const auto& kv : pending_) {
    if (!first) out << ",";
    first = false;
    out << "{\"name\":\"";
    JsonEscape(out, kv.second.name);
    out << "\",\"age_us\":" << (now - kv.second.start_us) << "}";
  }
  out << "]}";
  return out.str();
}

void TimerManager::StartTrace() {
  std::lock_guard<std::mutex> lock(mu_);
  trace_.clear();
  tracing_ = true;
}

void TimerManager::StopTrace() { tracing_ = false; }

std::string TimerManager::TimelineJson() {
  // Chrome trace-event format; loadable in Perfetto (reference
  // py_xpu_timer/dump_timeline.py emits the same shape).
  std::lock_guard<std::mutex> lock(mu_);
  std::ostringstream out;
  out << "{\"traceEvents\":[";
  bool first = true;
  for (const auto& ev : trace_) {
    if (!first) out << ",";
    first = false;
    out << "{\"name\":\"";
    JsonEscape(out, ev.name);
    out << "\",\"cat\":\"" << ev.kind << "\",\"ph\":\"X\",\"ts\":"
        << ev.start_us << ",\"dur\":" << ev.dur_us
        << ",\"pid\":1,\"tid\":" << (ev.kind[0] == 'c' ? 2 : 1) << "}";
  }
  out << "]}";
  return out.str();
}

}  // namespace dlrover_torch
