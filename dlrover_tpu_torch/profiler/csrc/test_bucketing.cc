// Unit driver for the metric-cardinality cap (the port's own copy of
// native/tpu_timer/test_bucketing.cc): record more programs than
// max_series, print the Prometheus text, let the python test assert the
// head stays per-program and the tail aggregates into flops-magnitude
// buckets (reference parity: bvar_prometheus.cc:1-232 bounds series
// cardinality by throughput level).
#include <unistd.h>

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <string>

#include "timer_manager.h"

using dlrover_torch::TimerManager;

int main(int argc, char** argv) {
  size_t max_series = argc > 1 ? (size_t)atoll(argv[1]) : 2;
  int n_programs = argc > 2 ? atoi(argv[2]) : 6;
  auto& mgr = TimerManager::Get();
  mgr.SetMaxSeries(max_series);
  for (int p = 0; p < n_programs; p++) {
    std::string name = "prog_" + std::to_string(p);
    // distinct flops magnitudes: 1e9, 1e10, ... so tail programs land in
    // distinguishable buckets
    mgr.RegisterCost(name, 1e9 * std::pow(10.0, p % 3), 1e6);
    mgr.RecordCompile(name, 1000 + p);
    // earlier programs get MORE device time -> they are the head
    for (int e = 0; e < (n_programs - p) * 2; e++) {
      uint64_t tok = mgr.BeginExecute(name);
      usleep(1000 * (n_programs - p));
      mgr.EndExecute(tok, false);
    }
  }
  std::printf("%s", mgr.PrometheusText().c_str());
  return 0;
}
