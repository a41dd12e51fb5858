// Minimal blocking HTTP/1.0 server for /metrics, /timeline, /pending,
// /healthz: the port's own copy of native/tpu_timer/http_server.h.
//
// Parity: reference xpu_timer exports bvar metrics through a brpc server on
// :18889 (xpu_timer/common/bvar_prometheus.cc); we serve the same payloads
// with plain sockets so the hook has zero dependencies. The serving
// thread never touches Python, so a worker blocked on the device answers.
#ifndef DLROVER_TORCH_TIMER_HTTP_SERVER_H_
#define DLROVER_TORCH_TIMER_HTTP_SERVER_H_

#include <atomic>
#include <thread>

namespace dlrover_torch {

class MetricsHttpServer {
 public:
  // port 0 disables the server. Returns the bound port (0 when disabled).
  int Start(int port);
  void Stop();
  int port() const { return port_; }
  static MetricsHttpServer& Get();

 private:
  void Serve();
  int listen_fd_ = -1;
  int port_ = 0;
  std::atomic<bool> stop_{false};
  std::thread thread_;
};

}  // namespace dlrover_torch

#endif  // DLROVER_TORCH_TIMER_HTTP_SERVER_H_
