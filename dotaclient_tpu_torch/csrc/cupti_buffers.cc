// Activity buffers for CUPTI's activity API, handed out and taken back in C.
//
// CUPTI calls its buffer callbacks on its own threads and from inside CUDA
// calls. A Python callback there needs the interpreter's lock while CUPTI
// may hold its own, and the thread holding the interpreter's lock may be in
// a CUDA call waiting for CUPTI's: a deadlock. So the callbacks are these C
// functions, which allocate, queue and count buffers under a mutex of their
// own; Python takes the completed buffers after a window
// (dt_cupti_take), reads their records (dt_cupti_parse, which calls
// cuptiActivityGetNextRecord through the pointer Python passes) and frees
// them (dt_cupti_release). No CUPTI header is needed: the record offsets are
// those of CUpti_ActivityAPI and of CUpti_ActivityKernel4 through CUDA 12's
// CUpti_ActivityKernel9.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

constexpr size_t kBufferBytes = 8u << 20;
constexpr uint32_t kKindDriver = 4, kKindRuntime = 5, kKindKernel = 10;

struct Completed {
    uint8_t* buffer;
    size_t valid;
};

std::mutex mu;
std::vector<Completed> completed;
int64_t held = 0;  // buffers CUPTI has and has not given back

template <typename T>
T at(const uint8_t* record, size_t offset) {
    T v;
    std::memcpy(&v, record + offset, sizeof(T));
    return v;
}

}  // namespace

extern "C" {

void dt_cupti_buffer_requested(uint8_t** buffer, size_t* size, size_t* max_records) {
    void* p = nullptr;
    if (posix_memalign(&p, 8, kBufferBytes) != 0) p = nullptr;  // CUPTI wants 8-byte alignment
    *buffer = static_cast<uint8_t*>(p);
    *size = p != nullptr ? kBufferBytes : 0;  // none: CUPTI counts the records it drops
    *max_records = 0;
    if (p != nullptr) {
        std::lock_guard<std::mutex> lock(mu);
        ++held;
    }
}

void dt_cupti_buffer_completed(void* /*context*/, uint32_t /*stream*/, uint8_t* buffer, size_t /*size*/,
                               size_t valid) {
    std::lock_guard<std::mutex> lock(mu);
    completed.push_back({buffer, valid});
    --held;
}

// Buffers CUPTI holds now (handed out, not given back).
int64_t dt_cupti_held() {
    std::lock_guard<std::mutex> lock(mu);
    return held;
}

// Moves up to `cap` completed buffers out: their pointers and valid bytes.
// Returns how many.
int64_t dt_cupti_take(uint8_t** buffers, uint64_t* valid, int64_t cap) {
    std::lock_guard<std::mutex> lock(mu);
    int64_t n = 0;
    while (n < cap && !completed.empty()) {
        buffers[n] = completed.back().buffer;
        valid[n] = completed.back().valid;
        completed.pop_back();
        ++n;
    }
    return n;
}

void dt_cupti_release(uint8_t* buffer) { std::free(buffer); }

using NextRecord = int (*)(uint8_t*, size_t, void**);

// The kernel, runtime and driver records of one buffer, up to `cap`, into
// column arrays; other kinds are skipped. Kernels: a = device, b = stream,
// c = 0, name = the kernel's. Calls: a = process, b = thread, c = callback
// id, name = NULL. Returns how many.
int64_t dt_cupti_parse(void* next_record, uint8_t* buffer, uint64_t valid, int64_t cap, uint32_t* kind, uint32_t* a,
                       uint32_t* b, uint32_t* c, uint32_t* correlation, uint64_t* start, uint64_t* end,
                       const char** name) {
    NextRecord next = reinterpret_cast<NextRecord>(next_record);
    void* record = nullptr;
    int64_t n = 0;
    while (n < cap && next(buffer, valid, &record) == 0) {
        const uint8_t* r = static_cast<const uint8_t*>(record);
        const uint32_t k = at<uint32_t>(r, 0);
        if (k == kKindKernel) {
            kind[n] = k;
            a[n] = at<uint32_t>(r, 40);
            b[n] = at<uint32_t>(r, 48);
            c[n] = 0;
            correlation[n] = at<uint32_t>(r, 92);
            start[n] = at<uint64_t>(r, 16);
            end[n] = at<uint64_t>(r, 24);
            name[n] = at<const char*>(r, 104);
            ++n;
        } else if (k == kKindRuntime || k == kKindDriver) {
            kind[n] = k;
            a[n] = at<uint32_t>(r, 24);
            b[n] = at<uint32_t>(r, 28);
            c[n] = at<uint32_t>(r, 4);
            correlation[n] = at<uint32_t>(r, 32);
            start[n] = at<uint64_t>(r, 8);
            end[n] = at<uint64_t>(r, 16);
            name[n] = nullptr;
            ++n;
        }
    }
    return n;
}

}  // extern "C"
