// Native tensor IO: an mmap-based parallel reader of file spans (the port's
// copy of the JAX package's native/tensor_io.cpp).
//
// Loading a multi-GB safetensors checkpoint is bound by single-threaded
// page faults and memcpy; this library maps the file, advises the kernel of
// sequential access and fans the copy out across threads.
//
// C ABI (bound with ctypes by perceptor_tpu_torch/utils/native_io.py, which
// builds it with g++ at first use):
//   pt_read_span(path, offset, nbytes, dst, n_threads) -> 0 on success
//   pt_file_size(path) -> size or -1

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

long long pt_file_size(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  return static_cast<long long>(st.st_size);
}

int pt_read_span(const char* path, unsigned long long offset,
                 unsigned long long nbytes, void* dst, int n_threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;

  struct stat st;
  if (fstat(fd, &st) != 0 || offset + nbytes > (unsigned long long)st.st_size) {
    close(fd);
    return -2;
  }

  // Page-align the mapping window.
  const unsigned long long page = sysconf(_SC_PAGESIZE);
  const unsigned long long map_start = (offset / page) * page;
  const unsigned long long map_len = nbytes + (offset - map_start);

  void* mapped = mmap(nullptr, map_len, PROT_READ, MAP_PRIVATE, fd, map_start);
  close(fd);
  if (mapped == MAP_FAILED) return -3;
  madvise(mapped, map_len, MADV_SEQUENTIAL | MADV_WILLNEED);

  const char* src = static_cast<const char*>(mapped) + (offset - map_start);
  char* out = static_cast<char*>(dst);

  if (n_threads <= 1 || nbytes < (8ull << 20)) {
    std::memcpy(out, src, nbytes);
  } else {
    std::vector<std::thread> workers;
    const unsigned long long chunk = (nbytes + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      const unsigned long long begin = chunk * t;
      if (begin >= nbytes) break;
      const unsigned long long len =
          begin + chunk > nbytes ? nbytes - begin : chunk;
      workers.emplace_back(
          [=]() { std::memcpy(out + begin, src + begin, len); });
    }
    for (auto& w : workers) w.join();
  }

  munmap(mapped, map_len);
  return 0;
}

}  // extern "C"
