// Native batch loader for mel-spectrogram chunk files.
//
// The reference delegates its hot IO path to torch DataLoader worker
// processes doing numpy memmap reads (reference: discogs/dataset.py:90-138,
// discogs/datamodule.py:246-252 — 16 worker processes per GPU). The TPU
// build replaces that with an in-process thread pool over pread(2):
// no pickling, no IPC, one contiguous page-aligned output buffer that
// feeds jax.device_put directly.
//
// File format: raw little-endian float16, frames-major, layout
// (n_frames, n_bands) — st_size == n_frames * n_bands * 2 (the extractor's
// output; see maest_tpu/apps/extract_mel.py).
//
// Exposed C ABI (ctypes):
//   mel_file_frames(path, n_bands)                  -> frame count or -1
//   mel_load_chunk(path, offset, chunk, bands, out) -> frames read or -1
//       center-pads with zeros when the file tail is short, matching
//       the Python loader (maest_tpu/data/dataset.py load_melspectrogram).
//   mel_load_batch(paths, offsets, n, chunk, bands, threads, out)
//       -> 0 on success, else count of failed items; failed rows zeroed.
//
// Build: g++ -O3 -shared -fPIC -o libmel_loader.so mel_loader.cpp -lpthread

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

int64_t file_size(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  return static_cast<int64_t>(st.st_size);
}

// Read [offset, offset+chunk) frames into out, zero-padding so that the
// valid data is centered when the read is short (tail of file).
int64_t load_chunk_impl(const char* path, int64_t offset_frames,
                        int64_t chunk_frames, int64_t n_bands,
                        uint16_t* out) {
  const int64_t row_bytes = n_bands * 2;
  const int64_t total = file_size(path);
  if (total < 0) return -1;
  const int64_t frames_in_file = total / row_bytes;

  // an empty (0-frame) file or an offset past EOF is a FAILURE, not a
  // silent all-zeros row: the numpy-memmap fallback raises on an empty
  // file, and a zeroed spectrogram with a real label would poison
  // training without any error (load_batch's raise-on-failure contract)
  if (frames_in_file <= 0) return -1;

  if (offset_frames < 0) offset_frames = 0;
  int64_t avail = frames_in_file - offset_frames;
  if (avail <= 0) return -1;
  int64_t to_read = chunk_frames < avail ? chunk_frames : avail;

  std::memset(out, 0, static_cast<size_t>(chunk_frames * row_bytes));

  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;

  // center the short read, like the Python _center_pad
  const int64_t pad_front =
      to_read < chunk_frames ? (chunk_frames - to_read) / 2 : 0;
  uint16_t* dst = out + pad_front * n_bands;
  int64_t want = to_read * row_bytes;
  int64_t off = offset_frames * row_bytes;
  char* p = reinterpret_cast<char*>(dst);
  while (want > 0) {
    ssize_t got = pread(fd, p, static_cast<size_t>(want), off);
    if (got < 0 && errno == EINTR) continue;  // interrupted syscall: retry
    if (got <= 0) {  // real error, or EOF mid-read (file truncated under us)
      close(fd);
      return -1;
    }
    want -= got;
    off += got;
    p += got;
  }
  close(fd);
  return to_read;
}

}  // namespace

extern "C" {

int64_t mel_file_frames(const char* path, int64_t n_bands) {
  int64_t total = file_size(path);
  if (total < 0) return -1;
  return total / (n_bands * 2);
}

int64_t mel_load_chunk(const char* path, int64_t offset_frames,
                       int64_t chunk_frames, int64_t n_bands, uint16_t* out) {
  return load_chunk_impl(path, offset_frames, chunk_frames, n_bands, out);
}

int64_t mel_load_batch(const char** paths, const int64_t* offsets, int64_t n,
                       int64_t chunk_frames, int64_t n_bands, int64_t threads,
                       uint16_t* out) {
  if (threads < 1) threads = 1;
  if (threads > n) threads = n;
  // more threads than cores only adds contention (page-cache reads are
  // CPU-bound memcpys)
  const int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
  if (hw > 0 && threads > hw) threads = hw;
  std::atomic<int64_t> next(0), failures(0);
  const int64_t item_elems = chunk_frames * n_bands;

  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      int64_t r = load_chunk_impl(paths[i], offsets[i], chunk_frames, n_bands,
                                  out + i * item_elems);
      if (r < 0) {
        std::memset(out + i * item_elems, 0,
                    static_cast<size_t>(item_elems * 2));
        failures.fetch_add(1);
      }
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(threads));
  for (int64_t t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
