// The port's own copy of native/tpu_timer/http_server.cc.
#include "http_server.h"

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdio>
#include <cstring>
#include <string>

#include "timer_manager.h"

namespace dlrover_torch {

MetricsHttpServer& MetricsHttpServer::Get() {
  static MetricsHttpServer* srv = new MetricsHttpServer();
  return *srv;
}

int MetricsHttpServer::Start(int port) {
  if (port <= 0) return 0;
  listen_fd_ = socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
  if (listen_fd_ < 0) return 0;
  int one = 1;
  setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(port);
  if (bind(listen_fd_, (struct sockaddr*)&addr, sizeof(addr)) != 0 ||
      listen(listen_fd_, 8) != 0) {
    fprintf(stderr, "[dlrover_torch_timer] metrics port %d unavailable\n", port);
    close(listen_fd_);
    listen_fd_ = -1;
    return 0;
  }
  socklen_t len = sizeof(addr);
  getsockname(listen_fd_, (struct sockaddr*)&addr, &len);
  port_ = ntohs(addr.sin_port);
  thread_ = StartQuietThread([this] { Serve(); });
  thread_.detach();
  fprintf(stderr, "[dlrover_torch_timer] metrics on 127.0.0.1:%d\n", port_);
  return port_;
}

void MetricsHttpServer::Stop() {
  stop_ = true;
  if (listen_fd_ >= 0) {
    shutdown(listen_fd_, SHUT_RDWR);
    close(listen_fd_);
    listen_fd_ = -1;
  }
}

static void Respond(int fd, const char* content_type,
                    const std::string& body) {
  char header[256];
  int n = snprintf(header, sizeof(header),
                   "HTTP/1.0 200 OK\r\nContent-Type: %s\r\n"
                   "Content-Length: %zu\r\nConnection: close\r\n\r\n",
                   content_type, body.size());
  (void)!write(fd, header, n);
  (void)!write(fd, body.data(), body.size());
}

void MetricsHttpServer::Serve() {
  while (!stop_) {
    int fd = accept(listen_fd_, nullptr, nullptr);
    if (fd < 0) {
      if (stop_) return;
      continue;
    }
    char buf[1024];
    ssize_t n = read(fd, buf, sizeof(buf) - 1);
    if (n > 0) {
      buf[n] = 0;
      auto& mgr = TimerManager::Get();
      if (strstr(buf, "GET /metrics"))
        Respond(fd, "text/plain", mgr.PrometheusText());
      else if (strstr(buf, "GET /timeline"))
        Respond(fd, "application/json", mgr.TimelineJson());
      else if (strstr(buf, "GET /pending"))
        Respond(fd, "application/json", mgr.PendingJson());
      else if (strstr(buf, " /trace/start")) {  // GET or POST
        mgr.StartTrace();
        Respond(fd, "application/json", "{\"tracing\":true}");
      } else if (strstr(buf, " /trace/stop")) {
        mgr.StopTrace();
        Respond(fd, "application/json", "{\"tracing\":false}");
      } else if (strstr(buf, "GET /healthz"))
        Respond(fd, "text/plain", "ok\n");
      else
        Respond(fd, "text/plain",
                "dlrover_torch_timer: /metrics /timeline /pending "
                "/trace/start /trace/stop\n");
    }
    close(fd);
  }
}

}  // namespace dlrover_torch
