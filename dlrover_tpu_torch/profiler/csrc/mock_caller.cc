// Stands in for libtorch_cuda in the CPU tests of cuda_hook.cc: a library
// linked against libnccl.so.2 (mock_nccl.cc) that calls NCCL as torch
// does. Loaded with RTLD_LOCAL, its libnccl.so.2 is not in the global
// scope, so the hook must find the real symbols with RTLD_NOLOAD.

#include <cstddef>

extern "C" {

int ncclAllReduce(const void*, void*, size_t, int, int, void*, void*);
int ncclReduceScatter(const void*, void*, size_t, int, int, void*, void*);
int ncclAllGather(const void*, void*, size_t, int, void*, void*);
int ncclBroadcast(const void*, void*, size_t, int, int, void*, void*);
int ncclReduce(const void*, void*, size_t, int, int, int, void*, void*);
int ncclSend(const void*, size_t, int, int, void*, void*);
int ncclRecv(void*, size_t, int, int, void*, void*);
int ncclGroupStart(void);
int ncclGroupEnd(void);
int mock_nccl_calls(void);

// op: AllReduce, ReduceScatter, AllGather, Broadcast, Reduce, Send, Recv
int caller_collective(const char* op, size_t count, int dtype, void* stream) {
  switch (op[0] == 'A' ? (op[3] == 'R' ? 0 : 2)
          : op[0] == 'R' ? (op[2] == 'c' ? 6 : (op[6] == 'S' ? 1 : 4))
          : op[0] == 'B' ? 3 : 5) {
    case 0: return ncclAllReduce(nullptr, nullptr, count, dtype, 0, nullptr, stream);
    case 1: return ncclReduceScatter(nullptr, nullptr, count, dtype, 0, nullptr, stream);
    case 2: return ncclAllGather(nullptr, nullptr, count, dtype, nullptr, stream);
    case 3: return ncclBroadcast(nullptr, nullptr, count, dtype, 0, nullptr, stream);
    case 4: return ncclReduce(nullptr, nullptr, count, dtype, 0, 0, nullptr, stream);
    case 5: return ncclSend(nullptr, count, dtype, 1, nullptr, stream);
    default: return ncclRecv(nullptr, count, dtype, 1, nullptr, stream);
  }
}

int caller_group_start(void) { return ncclGroupStart(); }
int caller_group_end(void) { return ncclGroupEnd(); }
int caller_nccl_calls(void) { return mock_nccl_calls(); }

}  // extern "C"
