// The device timer's hook for an NVIDIA card: an LD_PRELOAD library that
// times NCCL's collectives and the trainer's step by CUDA events.
//
// Counterpart of native/tpu_timer/interposer.cc, which wraps the PJRT
// plugin table of a TPU. Here the seam is where the reference's xpu_timer
// puts it (xpu_timer/nvidia/hook.cc:54-121): the library defines NCCL's
// exported collectives (ncclAllReduce, ncclReduceScatter, ncclAllGather,
// ncclBroadcast, ncclReduce, ncclSend, ncclRecv, ncclGroupStart,
// ncclGroupEnd) and forwards each to the real symbol. Around each forwarded
// call it records a start and an end event on the caller's stream and
// calls TimerManager::BeginExecute with a name such as "nccl:AllReduce";
// the cost is the call's bytes (its count times its type's size). Inside
// ncclGroupStart/ncclGroupEnd a collective is only enqueued at the
// outermost ncclGroupEnd, so a group is timed there, as one execution
// named after its collectives. A stream that is capturing a CUDA graph is
// not timed.
//
// A poller thread takes the place of the PJRT OnReady callback: it checks
// the pending end events with cuEventQuery and calls EndExecute once one
// has passed, with the device time between the two events
// (cuEventElapsedTime). So a collective's latency does not count the time
// it waited behind earlier work on its stream. A pending execution still
// ages on the host clock from its call, and the manager's watcher flags a
// hang when the oldest one passes DLROVER_TPU_TIMER_HANG_SECS.
//
// The library also exports a small C API (dlrover_torch_timer_*): the
// trainer times its step as the program "train_step" through begin/end on
// its current stream, with a cost of 6*params*tokens flops, which feeds the
// manager's MFU gauge (peak from DLROVER_TPU_TIMER_PEAK_TFLOPS).
//
// The driver is reached only through dlopen("libcuda.so.1") and its cu*
// entry points (one driver instance per process, whatever runtime torch
// loaded), and the few opaque CUDA and NCCL types are declared here, so g++
// builds the library with no CUDA header and the CPU tests load it against
// mocks (mock_cuda.cc, mock_nccl.cc). The real NCCL is looked up in the
// libnccl.so.2 already loaded (dlopen with RTLD_NOLOAD): Python loads torch
// with RTLD_LOCAL, where dlsym(RTLD_NEXT, ...) does not see it. A hook that
// cannot find the driver or the real NCCL symbol ends the process (exit
// 70): it never runs a job untimed.
//
// The constructor removes the library from LD_PRELOAD before the program
// reads its environment, so the processes a worker starts (nvcc, for one)
// neither load the hook nor start a second metrics server on its port.

#include <dlfcn.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "http_server.h"
#include "timer_manager.h"

// -- the opaque types of the driver and of NCCL, declared by hand ----------
typedef int CUresult;
typedef struct CUctx_st* CUcontext;
typedef struct CUevent_st* CUevent;
typedef struct CUstream_st* CUstream;
typedef struct ncclComm* ncclComm_t;
typedef int ncclResult_t;
typedef int ncclDataType_t;
typedef int ncclRedOp_t;

namespace dlrover_torch {
namespace {

constexpr CUresult kCudaSuccess = 0;
constexpr CUresult kCudaNotReady = 600;
constexpr int kCaptureModeRelaxed = 2;
constexpr int kFatalExit = 70;

[[noreturn]] void Fatal(const char* what, const char* detail) {
  fprintf(stderr, "[dlrover_torch_timer] FATAL: %s%s%s\n", what,
          detail ? ": " : "", detail ? detail : "");
  fflush(stderr);
  _exit(kFatalExit);
}

// -- the driver, through dlopen ---------------------------------------------
struct Driver {
  CUresult (*ctx_get_current)(CUcontext*) = nullptr;
  CUresult (*ctx_set_current)(CUcontext) = nullptr;
  CUresult (*event_create)(CUevent*, unsigned) = nullptr;
  CUresult (*event_record)(CUevent, CUstream) = nullptr;
  CUresult (*event_query)(CUevent) = nullptr;
  CUresult (*event_elapsed)(float*, CUevent, CUevent) = nullptr;
  CUresult (*event_destroy)(CUevent) = nullptr;
  CUresult (*stream_is_capturing)(CUstream, int*) = nullptr;
  CUresult (*exchange_capture_mode)(int*) = nullptr;
  std::string error;  // empty once every entry point resolved
};

const Driver& LoadDriver() {
  static Driver* drv = [] {
    Driver* d = new Driver();
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (h == nullptr) {
      const char* e = dlerror();
      d->error = std::string("dlopen(libcuda.so.1) failed: ") +
                 (e ? e : "unknown");
      return d;
    }
    auto sym = [&](const char* name, const char* fallback) -> void* {
      void* p = dlsym(h, name);
      if (p == nullptr && fallback != nullptr) p = dlsym(h, fallback);
      if (p == nullptr && d->error.empty())
        d->error = std::string("libcuda.so.1 has no ") + name;
      return p;
    };
    d->ctx_get_current = reinterpret_cast<decltype(d->ctx_get_current)>(
        sym("cuCtxGetCurrent", nullptr));
    d->ctx_set_current = reinterpret_cast<decltype(d->ctx_set_current)>(
        sym("cuCtxSetCurrent", nullptr));
    d->event_create = reinterpret_cast<decltype(d->event_create)>(
        sym("cuEventCreate", nullptr));
    d->event_record = reinterpret_cast<decltype(d->event_record)>(
        sym("cuEventRecord", nullptr));
    d->event_query = reinterpret_cast<decltype(d->event_query)>(
        sym("cuEventQuery", nullptr));
    d->event_elapsed = reinterpret_cast<decltype(d->event_elapsed)>(
        sym("cuEventElapsedTime", nullptr));
    d->event_destroy = reinterpret_cast<decltype(d->event_destroy)>(
        sym("cuEventDestroy_v2", "cuEventDestroy"));
    d->stream_is_capturing =
        reinterpret_cast<decltype(d->stream_is_capturing)>(
            sym("cuStreamIsCapturing", nullptr));
    d->exchange_capture_mode =
        reinterpret_cast<decltype(d->exchange_capture_mode)>(
            sym("cuThreadExchangeStreamCaptureMode", nullptr));
    return d;
  }();
  return *drv;
}

const Driver& DriverOrDie() {
  const Driver& d = LoadDriver();
  if (!d.error.empty()) Fatal("the CUDA driver is unusable", d.error.c_str());
  return d;
}

// -- the real NCCL ----------------------------------------------------------
void* LookupNccl(const char* name) {
  void* h = dlopen("libnccl.so.2", RTLD_NOLOAD | RTLD_LAZY);
  void* p = h != nullptr ? dlsym(h, name) : dlsym(RTLD_NEXT, name);
  return p;
}

template <typename Fn>
Fn RealNccl(std::atomic<void*>& slot, const char* name) {
  void* p = slot.load(std::memory_order_acquire);
  if (p == nullptr) {
    p = LookupNccl(name);
    if (p == nullptr)
      Fatal("cannot find the real NCCL symbol (is libnccl.so.2 loaded?)",
            name);
    slot.store(p, std::memory_order_release);
  }
  return reinterpret_cast<Fn>(p);
}

size_t TypeSize(ncclDataType_t t) {
  // ncclInt8, ncclUint8, ncclInt32, ncclUint32, ncclInt64, ncclUint64,
  // ncclFloat16, ncclFloat32, ncclFloat64, ncclBfloat16, fp8 e4m3, e5m2
  static const size_t sizes[] = {1, 1, 4, 4, 8, 8, 2, 4, 8, 2, 1, 1};
  return (t >= 0 && t < 12) ? sizes[t] : 1;
}

// -- pending executions and the poller --------------------------------------
struct Span {
  uint64_t token;
  CUcontext ctx;
  CUevent start;
  CUevent end;  // null until the end is recorded
};

std::mutex g_mu;
std::vector<Span> g_open;    // begun, end not recorded (C API scopes)
std::vector<Span> g_closed;  // end recorded, waiting for the poller

void PollLoop() {
  const Driver& d = DriverOrDie();
  // the poller's own queries must never break a graph another thread
  // captures in the global mode
  int mode = kCaptureModeRelaxed;
  d.exchange_capture_mode(&mode);
  CUcontext bound = nullptr;
  for (;;) {
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
    std::vector<Span> ready;
    {
      std::lock_guard<std::mutex> lock(g_mu);
      ready.swap(g_closed);
    }
    std::vector<Span> still;
    for (const Span& s : ready) {
      if (s.ctx != bound) {
        d.ctx_set_current(s.ctx);
        bound = s.ctx;
      }
      CUresult r = d.event_query(s.end);
      if (r == kCudaNotReady) {
        still.push_back(s);
        continue;
      }
      float ms = 0.f;
      bool error = r != kCudaSuccess ||
                   d.event_elapsed(&ms, s.start, s.end) != kCudaSuccess;
      TimerManager::Get().EndExecute(
          s.token, error, error ? -1 : static_cast<int64_t>(ms * 1000.0));
      d.event_destroy(s.start);
      d.event_destroy(s.end);
    }
    if (!still.empty()) {
      std::lock_guard<std::mutex> lock(g_mu);
      g_closed.insert(g_closed.begin(), still.begin(), still.end());
    }
  }
}

void EnsurePoller() {
  static std::once_flag once;
  std::call_once(once, [] { StartQuietThread([] { PollLoop(); }).detach(); });
}

bool Capturing(const Driver& d, CUstream stream) {
  int status = 0;
  // an error (the legacy stream while another stream captures) counts
  // as capturing: nothing is recorded then
  return d.stream_is_capturing(stream, &status) != kCudaSuccess ||
         status != 0;
}

// Record a start event on `stream` and open an execution. Returns false
// (nothing recorded) on a capturing stream or without a context.
bool Open(const std::string& name, double flops, double bytes,
          CUstream stream, Span* out) {
  const Driver& d = DriverOrDie();
  if (Capturing(d, stream)) return false;
  CUcontext ctx = nullptr;
  if (d.ctx_get_current(&ctx) != kCudaSuccess || ctx == nullptr) return false;
  CUevent start = nullptr;
  if (d.event_create(&start, 0) != kCudaSuccess) return false;
  if (d.event_record(start, stream) != kCudaSuccess) {
    d.event_destroy(start);
    return false;
  }
  auto& mgr = TimerManager::Get();
  if (flops > 0 || bytes > 0) mgr.RegisterCost(name, flops, bytes);
  *out = Span{mgr.BeginExecute(name), ctx, start, nullptr};
  return true;
}

// Record the end event of an open execution on `stream` and hand it to
// the poller; a failed record ends it as an error.
void Close(Span span, CUstream stream) {
  const Driver& d = DriverOrDie();
  CUevent end = nullptr;
  if (d.event_create(&end, 0) != kCudaSuccess ||
      d.event_record(end, stream) != kCudaSuccess) {
    if (end != nullptr) d.event_destroy(end);
    d.event_destroy(span.start);
    TimerManager::Get().EndExecute(span.token, true);
    return;
  }
  span.end = end;
  EnsurePoller();
  std::lock_guard<std::mutex> lock(g_mu);
  g_closed.push_back(span);
}

// -- groups -----------------------------------------------------------------
struct GroupCall {
  const char* op;
  double bytes;
  CUstream stream;
};
thread_local int t_group_depth = 0;
thread_local std::vector<GroupCall> t_group;

std::string GroupName() {
  const char* op = t_group.front().op;
  for (const GroupCall& c : t_group)
    if (strcmp(c.op, op) != 0) return "nccl:Group";
  return std::string("nccl:") + op;
}

// Open the program `name` on `stream`, make the NCCL call, and close it;
// a call that fails ends the execution as an error.
template <typename Call>
ncclResult_t TimeCall(const std::string& name, double bytes, CUstream stream,
                      Call&& call) {
  Span span;
  bool timed = Open(name, 0.0, bytes, stream, &span);
  ncclResult_t r = call();
  if (timed) {
    if (r != 0) {
      DriverOrDie().event_destroy(span.start);
      TimerManager::Get().EndExecute(span.token, true);
    } else {
      Close(span, stream);
    }
  }
  return r;
}

// Time one collective, or queue it for its group's end.
template <typename Call>
ncclResult_t Timed(const char* op, double bytes, CUstream stream,
                   Call&& call) {
  if (t_group_depth > 0) {
    t_group.push_back({op, bytes, stream});
    return call();
  }
  return TimeCall(std::string("nccl:") + op, bytes, stream, call);
}

// -- the preload itself -----------------------------------------------------
void ScrubPreload() {
  Dl_info info;
  const char* preload = getenv("LD_PRELOAD");
  if (preload == nullptr ||
      dladdr(reinterpret_cast<void*>(&ScrubPreload), &info) == 0 ||
      info.dli_fname == nullptr)
    return;
  const char* self = strrchr(info.dli_fname, '/');
  self = self ? self + 1 : info.dli_fname;
  std::string kept, entry;
  std::string list(preload);
  list.push_back(':');
  for (char c : list) {
    if (c != ':' && c != ' ') {
      entry.push_back(c);
      continue;
    }
    if (entry.empty()) continue;
    const char* base = strrchr(entry.c_str(), '/');
    base = base ? base + 1 : entry.c_str();
    if (strcmp(base, self) != 0) {
      if (!kept.empty()) kept.push_back(':');
      kept += entry;
    }
    entry.clear();
  }
  if (kept.empty())
    unsetenv("LD_PRELOAD");
  else
    setenv("LD_PRELOAD", kept.c_str(), 1);
}

__attribute__((constructor)) void OnLoad() {
  ScrubPreload();
  const char* port_env = getenv("DLROVER_TPU_TIMER_PORT");
  int port = port_env ? atoi(port_env) : 18890;
  MetricsHttpServer::Get().Start(port);
  TimerManager::Get();  // starts the hang watcher
}

std::atomic<void*> g_all_reduce{nullptr}, g_reduce_scatter{nullptr},
    g_all_gather{nullptr}, g_broadcast{nullptr}, g_reduce{nullptr},
    g_send{nullptr}, g_recv{nullptr}, g_group_start{nullptr},
    g_group_end{nullptr};

}  // namespace
}  // namespace dlrover_torch

using namespace dlrover_torch;  // NOLINT

extern "C" {

ncclResult_t ncclAllReduce(const void* sendbuff, void* recvbuff, size_t count,
                           ncclDataType_t datatype, ncclRedOp_t op,
                           ncclComm_t comm, CUstream stream) {
  using Fn = ncclResult_t (*)(const void*, void*, size_t, ncclDataType_t,
                              ncclRedOp_t, ncclComm_t, CUstream);
  Fn real = RealNccl<Fn>(g_all_reduce, "ncclAllReduce");
  return Timed("AllReduce", double(count) * TypeSize(datatype), stream, [&] {
    return real(sendbuff, recvbuff, count, datatype, op, comm, stream);
  });
}

ncclResult_t ncclReduceScatter(const void* sendbuff, void* recvbuff,
                               size_t recvcount, ncclDataType_t datatype,
                               ncclRedOp_t op, ncclComm_t comm,
                               CUstream stream) {
  using Fn = ncclResult_t (*)(const void*, void*, size_t, ncclDataType_t,
                              ncclRedOp_t, ncclComm_t, CUstream);
  Fn real = RealNccl<Fn>(g_reduce_scatter, "ncclReduceScatter");
  return Timed("ReduceScatter", double(recvcount) * TypeSize(datatype),
               stream, [&] {
                 return real(sendbuff, recvbuff, recvcount, datatype, op,
                             comm, stream);
               });
}

ncclResult_t ncclAllGather(const void* sendbuff, void* recvbuff,
                           size_t sendcount, ncclDataType_t datatype,
                           ncclComm_t comm, CUstream stream) {
  using Fn = ncclResult_t (*)(const void*, void*, size_t, ncclDataType_t,
                              ncclComm_t, CUstream);
  Fn real = RealNccl<Fn>(g_all_gather, "ncclAllGather");
  return Timed("AllGather", double(sendcount) * TypeSize(datatype), stream,
               [&] {
                 return real(sendbuff, recvbuff, sendcount, datatype, comm,
                             stream);
               });
}

ncclResult_t ncclBroadcast(const void* sendbuff, void* recvbuff, size_t count,
                           ncclDataType_t datatype, int root, ncclComm_t comm,
                           CUstream stream) {
  using Fn = ncclResult_t (*)(const void*, void*, size_t, ncclDataType_t, int,
                              ncclComm_t, CUstream);
  Fn real = RealNccl<Fn>(g_broadcast, "ncclBroadcast");
  return Timed("Broadcast", double(count) * TypeSize(datatype), stream, [&] {
    return real(sendbuff, recvbuff, count, datatype, root, comm, stream);
  });
}

ncclResult_t ncclReduce(const void* sendbuff, void* recvbuff, size_t count,
                        ncclDataType_t datatype, ncclRedOp_t op, int root,
                        ncclComm_t comm, CUstream stream) {
  using Fn = ncclResult_t (*)(const void*, void*, size_t, ncclDataType_t,
                              ncclRedOp_t, int, ncclComm_t, CUstream);
  Fn real = RealNccl<Fn>(g_reduce, "ncclReduce");
  return Timed("Reduce", double(count) * TypeSize(datatype), stream, [&] {
    return real(sendbuff, recvbuff, count, datatype, op, root, comm, stream);
  });
}

ncclResult_t ncclSend(const void* sendbuff, size_t count,
                      ncclDataType_t datatype, int peer, ncclComm_t comm,
                      CUstream stream) {
  using Fn = ncclResult_t (*)(const void*, size_t, ncclDataType_t, int,
                              ncclComm_t, CUstream);
  Fn real = RealNccl<Fn>(g_send, "ncclSend");
  return Timed("Send", double(count) * TypeSize(datatype), stream, [&] {
    return real(sendbuff, count, datatype, peer, comm, stream);
  });
}

ncclResult_t ncclRecv(void* recvbuff, size_t count, ncclDataType_t datatype,
                      int peer, ncclComm_t comm, CUstream stream) {
  using Fn = ncclResult_t (*)(void*, size_t, ncclDataType_t, int, ncclComm_t,
                              CUstream);
  Fn real = RealNccl<Fn>(g_recv, "ncclRecv");
  return Timed("Recv", double(count) * TypeSize(datatype), stream, [&] {
    return real(recvbuff, count, datatype, peer, comm, stream);
  });
}

ncclResult_t ncclGroupStart(void) {
  using Fn = ncclResult_t (*)(void);
  Fn real = RealNccl<Fn>(g_group_start, "ncclGroupStart");
  if (t_group_depth++ == 0) t_group.clear();
  return real();
}

ncclResult_t ncclGroupEnd(void) {
  using Fn = ncclResult_t (*)(void);
  Fn real = RealNccl<Fn>(g_group_end, "ncclGroupEnd");
  if (t_group_depth > 0) t_group_depth--;
  if (t_group_depth > 0 || t_group.empty()) return real();
  double bytes = 0;
  for (const GroupCall& c : t_group) bytes += c.bytes;
  CUstream stream = t_group.front().stream;
  std::string name = GroupName();
  t_group.clear();
  return TimeCall(name, bytes, stream, real);
}

// -- the C API ---------------------------------------------------------------

// 1 in a process that loaded the hook (the agent's load check reads it).
int dlrover_torch_timer_active(void) { return 1; }

// 0 when libcuda.so.1 and every cu* entry point the hook uses resolve;
// otherwise 1, with the reason on stderr.
int dlrover_torch_timer_check_driver(void) {
  const Driver& d = LoadDriver();
  if (d.error.empty()) return 0;
  fprintf(stderr, "[dlrover_torch_timer] %s\n", d.error.c_str());
  return 1;
}

// 0 when the real ncclAllReduce resolves in the loaded libnccl.so.2.
int dlrover_torch_timer_check_nccl(void) {
  if (LookupNccl("ncclAllReduce") != nullptr) return 0;
  fprintf(stderr, "[dlrover_torch_timer] no real ncclAllReduce\n");
  return 1;
}

// The metrics server's port (0: disabled).
int dlrover_torch_timer_port(void) { return MetricsHttpServer::Get().port(); }

// Open `name` on `stream` (a CUstream as an integer); returns its token,
// 0 when nothing was recorded (a capturing stream). flops > 0 sets the
// program's per-execution cost.
uint64_t dlrover_torch_timer_begin(const char* name, uintptr_t stream,
                                   double flops) {
  Span span;
  if (!Open(name, flops, 0.0, reinterpret_cast<CUstream>(stream), &span))
    return 0;
  std::lock_guard<std::mutex> lock(g_mu);
  g_open.push_back(span);
  return span.token;
}

// Close the execution `token` opened with the end event on `stream`.
void dlrover_torch_timer_end(uint64_t token, uintptr_t stream) {
  if (token == 0) return;
  Span span{};
  {
    std::lock_guard<std::mutex> lock(g_mu);
    for (size_t i = 0; i < g_open.size(); i++) {
      if (g_open[i].token == token) {
        span = g_open[i];
        g_open.erase(g_open.begin() + i);
        break;
      }
    }
  }
  if (span.token == 0) return;
  Close(span, reinterpret_cast<CUstream>(stream));
}

}  // extern "C"
