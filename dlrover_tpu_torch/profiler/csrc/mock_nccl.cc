// A stand-in for libnccl.so.2 (built with that soname, linked against
// mock_cuda.cc's libcuda.so.1) for the CPU tests of cuda_hook.cc. Each
// collective queues MOCK_NCCL_US microseconds of device work on its stream
// (MOCK_NCCL_HANG=1: work that never ends) and counts the call; inside
// ncclGroupStart/ncclGroupEnd the work is queued at the group's end, as
// NCCL enqueues a group.

#include <cstddef>
#include <cstdint>
#include <cstdlib>

extern "C" void mock_cuda_enqueue(void* stream, int64_t us);

namespace {

int calls = 0;
int group_depth = 0;
void* group_stream = nullptr;
int64_t group_us = 0;

int64_t WorkUs() {
  const char* hang = getenv("MOCK_NCCL_HANG");
  const char* us = getenv("MOCK_NCCL_US");
  return hang && hang[0] == '1' ? -1 : (us ? atoll(us) : 20000);
}

int Collective(void* stream) {
  calls++;
  int64_t us = WorkUs();
  if (group_depth == 0) {
    mock_cuda_enqueue(stream, us);
  } else {
    group_stream = stream;
    group_us = group_us < 0 || us < 0 ? -1 : group_us + us;
  }
  return 0;
}

}  // namespace

extern "C" {

int ncclAllReduce(const void*, void*, size_t, int, int, void*, void* s) {
  return Collective(s);
}
int ncclReduceScatter(const void*, void*, size_t, int, int, void*, void* s) {
  return Collective(s);
}
int ncclAllGather(const void*, void*, size_t, int, void*, void* s) {
  return Collective(s);
}
int ncclBroadcast(const void*, void*, size_t, int, int, void*, void* s) {
  return Collective(s);
}
int ncclReduce(const void*, void*, size_t, int, int, int, void*, void* s) {
  return Collective(s);
}
int ncclSend(const void*, size_t, int, int, void*, void* s) {
  return Collective(s);
}
int ncclRecv(void*, size_t, int, int, void*, void* s) {
  return Collective(s);
}
int ncclGroupStart(void) {
  if (group_depth++ == 0) group_us = 0;
  return 0;
}
int ncclGroupEnd(void) {
  if (--group_depth == 0 && group_stream != nullptr) {
    mock_cuda_enqueue(group_stream, group_us);
    group_stream = nullptr;
  }
  return 0;
}

int mock_nccl_calls(void) { return calls; }

}  // extern "C"
