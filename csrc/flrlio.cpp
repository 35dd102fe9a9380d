// Native host runtime for the FL/RL compression framework.
//
// Re-expresses the reference's host-side C++ (file I/O: /root/reference/
// src/file_io.cu; CPU codec: src/fl/fl_cpu.cu) as an original,
// OpenMP-parallel shared library with a plain C ABI consumed from Python
// via ctypes.  The kernels' semantics are pinned by the Python golden
// implementations and the differential test suite; this library exists so
// the host paths (file staging, container writes, CPU fallback codec) run
// at memory/disk speed instead of interpreter speed.
//
// Design notes (vs the reference, which is sequential on host):
//  * FL frames are independent and full frames are byte-aligned for
//    frame lengths divisible by 8 (SURVEY.md finding #3), so both encode
//    passes and the whole decode parallelize over frames after one cheap
//    serial prefix scan of per-frame byte counts.
//  * All sizes are int64 (the reference's `int` chunk math overflows past
//    2 GB, file_io.cu:46-51 — fixed, not replicated).
//  * Bit packing uses a 64-bit accumulator per frame, LSB-first within
//    bytes — the container layout of file_io.cu:236-273.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

inline int required_bits(uint8_t v) {
  int b = 32 - __builtin_clz(static_cast<uint32_t>(v) | 1u);
  return b;  // >= 1 by construction (floor of 1 for zero bytes)
}

// Per-frame fold: concatenate wpf fields of 4*b bits each into nbytes
// output bytes (word-granular fast path for full frames — their payload
// is 16*b bytes, a multiple of 4; the global tail frame takes the byte
// path).
inline void fold_frame(const uint32_t* in, int wpf, int b4, uint8_t* out,
                       int64_t nbytes) {
  uint64_t acc = 0;
  int accbits = 0;
  int64_t w = 0;
  int q = 0;
  if (nbytes % 4 == 0) {
    const int64_t nwords = nbytes / 4;
    int64_t ww = 0;
    for (; q < wpf && ww < nwords; ++q) {
      acc |= static_cast<uint64_t>(in[q]) << accbits;
      accbits += b4;
      while (accbits >= 32 && ww < nwords) {
        const uint32_t lo = static_cast<uint32_t>(acc);
        memcpy(out + 4 * ww, &lo, 4);
        ++ww;
        acc >>= 32;
        accbits -= 32;
      }
    }
  } else {
    for (; q < wpf; ++q) {
      acc |= static_cast<uint64_t>(in[q]) << accbits;
      accbits += b4;
      if (accbits >= 32) {
        if (w + 4 <= nbytes) {
          const uint32_t lo = static_cast<uint32_t>(acc);
          memcpy(out + w, &lo, 4);
          w += 4;
          acc >>= 32;
          accbits -= 32;
        } else {
          break;
        }
      }
    }
    while (w < nbytes) {
      out[w++] = static_cast<uint8_t>(acc & 0xFF);
      acc >>= 8;
    }
  }
}

// Per-frame unfold: nbytes of the dense stream -> wpf fields of 4*b bits.
inline void unfold_frame(const uint8_t* in, int64_t nbytes, int wpf,
                         int b4, uint64_t fmask, uint32_t* out) {
  uint64_t acc = 0;
  int accbits = 0;
  int64_t r = 0;
  for (int q = 0; q < wpf; ++q) {
    while (accbits < b4) {
      if (r + 4 <= nbytes) {          // word-granular refill
        uint32_t lo;
        memcpy(&lo, in + r, 4);
        acc |= static_cast<uint64_t>(lo) << accbits;
        r += 4;
        accbits += 32;
      } else if (r < nbytes) {
        acc |= static_cast<uint64_t>(in[r++]) << accbits;
        accbits += 8;
      } else {
        break;
      }
    }
    out[q] = static_cast<uint32_t>(acc & fmask);
    acc >>= b4;
    accbits = accbits > b4 ? accbits - b4 : 0;
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// File I/O
// ---------------------------------------------------------------------------

int64_t flrl_file_size(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  return static_cast<int64_t>(st.st_size);
}

// Read [off, off+len) of the file into out.  Returns 0 on success.
int flrl_read_range(const char* path, int64_t off, int64_t len,
                    uint8_t* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
#ifdef POSIX_FADV_SEQUENTIAL
  posix_fadvise(fd, off, len, POSIX_FADV_SEQUENTIAL);
#endif
  int64_t done = 0;
  while (done < len) {
    ssize_t r = pread(fd, out + done, static_cast<size_t>(len - done),
                      static_cast<off_t>(off + done));
    if (r < 0) { close(fd); return -2; }
    if (r == 0) break;  // EOF
    done += r;
  }
  close(fd);
  return done == len ? 0 : -3;
}

int flrl_read_file(const char* path, uint8_t* out, int64_t cap) {
  int64_t sz = flrl_file_size(path);
  if (sz < 0 || sz > cap) return -1;
  return flrl_read_range(path, 0, sz, out);
}

int flrl_write_file(const char* path, const uint8_t* buf, int64_t len) {
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  int64_t done = 0;
  while (done < len) {
    ssize_t w = write(fd, buf + done, static_cast<size_t>(len - done));
    if (w < 0) { close(fd); return -2; }
    done += w;
  }
  close(fd);
  return 0;
}

// Container write: [input u64][asz u64][bsz u64][a bytes][b bytes]
// (the reference FL layout, file_io.cu:236-273; RL uses the same shape).
int flrl_write_container(const char* path, uint64_t input_size,
                         const uint8_t* a, uint64_t asz,
                         const uint8_t* b, uint64_t bsz) {
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  uint64_t hdr[3] = {input_size, asz, bsz};
  struct Piece { const uint8_t* p; uint64_t n; };
  Piece pieces[3] = {{reinterpret_cast<const uint8_t*>(hdr), sizeof hdr},
                     {a, asz}, {b, bsz}};
  for (const Piece& pc : pieces) {
    uint64_t done = 0;
    while (done < pc.n) {
      ssize_t w = write(fd, pc.p + done, static_cast<size_t>(pc.n - done));
      if (w < 0) { close(fd); return -2; }
      done += static_cast<uint64_t>(w);
    }
  }
  close(fd);
  return 0;
}

// ---------------------------------------------------------------------------
// FL codec (host fallback / golden-speed path)
// ---------------------------------------------------------------------------

// bits_out: ceil(n/L) bytes.  values_out capacity: n + L (worst case).
// Returns values_size, or -1 on bad args.
int64_t flrl_fl_encode(const uint8_t* data, int64_t n, int frame_len,
                       uint8_t* bits_out, uint8_t* values_out) {
  if (n < 0 || frame_len <= 0 || frame_len % 8 != 0) return -1;
  if (n == 0) return 0;
  const int64_t frames = (n + frame_len - 1) / frame_len;

  // Pass 1: per-frame bit widths (parallel; frames are independent).
#pragma omp parallel for schedule(static)
  for (int64_t f = 0; f < frames; ++f) {
    const int64_t lo = f * frame_len;
    const int64_t hi = lo + frame_len < n ? lo + frame_len : n;
    uint8_t m = 0;
    for (int64_t i = lo; i < hi; ++i) m = data[i] > m ? data[i] : m;
    bits_out[f] = static_cast<uint8_t>(required_bits(m));
  }

  // Serial exclusive scan of per-frame byte counts (full frames are
  // byte-aligned because 8 | frame_len — finding #3).
  int64_t values_size = 0;
  // offsets computed on the fly in pass 2 via a second scan; store base per
  // frame in a stack-free way: recompute with a parallel-friendly blocked
  // scan.  frames is at most n/L; one serial pass over it is cheap.
  int64_t* offs = new int64_t[frames + 1];
  offs[0] = 0;
  for (int64_t f = 0; f < frames; ++f) {
    const int64_t lo = f * frame_len;
    const int64_t hi = lo + frame_len < n ? lo + frame_len : n;
    offs[f + 1] = offs[f] + (static_cast<int64_t>(bits_out[f]) * (hi - lo) + 7) / 8;
  }
  values_size = offs[frames];

  // Pass 2: pack each frame at its width (parallel, disjoint output).
#pragma omp parallel for schedule(static)
  for (int64_t f = 0; f < frames; ++f) {
    const int b = bits_out[f];
    const int64_t lo = f * frame_len;
    const int64_t hi = lo + frame_len < n ? lo + frame_len : n;
    uint8_t* out = values_out + offs[f];
    uint64_t acc = 0;
    int accbits = 0;
    int64_t w = 0;
    for (int64_t i = lo; i < hi; ++i) {
      acc |= static_cast<uint64_t>(data[i]) << accbits;
      accbits += b;
      while (accbits >= 8) {
        out[w++] = static_cast<uint8_t>(acc & 0xFF);
        acc >>= 8;
        accbits -= 8;
      }
    }
    if (accbits > 0) out[w++] = static_cast<uint8_t>(acc & 0xFF);
  }
  delete[] offs;
  return values_size;
}

// Returns 0 on success.
int flrl_fl_decode(const uint8_t* bits, int64_t frames,
                   const uint8_t* values, int64_t values_size, int frame_len,
                   uint8_t* out, int64_t n) {
  if (n < 0 || frame_len <= 0 || frame_len % 8 != 0) return -1;
  if (n == 0) return 0;
  if (frames != (n + frame_len - 1) / frame_len) return -2;

  int64_t* offs = new int64_t[frames + 1];
  offs[0] = 0;
  for (int64_t f = 0; f < frames; ++f) {
    const int64_t lo = f * frame_len;
    const int64_t hi = lo + frame_len < n ? lo + frame_len : n;
    if (bits[f] < 1 || bits[f] > 8) { delete[] offs; return -5; }
    offs[f + 1] = offs[f] + (static_cast<int64_t>(bits[f]) * (hi - lo) + 7) / 8;
  }
  if (offs[frames] > values_size) { delete[] offs; return -3; }

#pragma omp parallel for schedule(static)
  for (int64_t f = 0; f < frames; ++f) {
    const int b = bits[f];
    const uint64_t mask = (1u << b) - 1u;
    const int64_t lo = f * frame_len;
    const int64_t hi = lo + frame_len < n ? lo + frame_len : n;
    const uint8_t* in = values + offs[f];
    uint64_t acc = 0;
    int accbits = 0;
    int64_t r = 0;
    for (int64_t i = lo; i < hi; ++i) {
      while (accbits < b) {
        acc |= static_cast<uint64_t>(in[r++]) << accbits;
        accbits += 8;
      }
      out[i] = static_cast<uint8_t>(acc & mask);
      acc >>= b;
      accbits -= b;
    }
  }
  delete[] offs;
  return 0;
}

// ---------------------------------------------------------------------------
// Field fold/unfold — the host half of the field route (frame lengths
// that are not a multiple of 32 bytes).
//
// The device emits "fields": per frame of L bytes, L/4 u32 values, field q
// holding the 4·b-bit spread of elements 4q..4q+3 (b = frame bit width).
// Fold concatenates each frame's fields into the byte-exact reference
// stream (funnel shifts, 64-bit accumulator); unfold is the inverse.
// Frames are independent (byte-aligned starts), so both parallelize.
// ---------------------------------------------------------------------------

// fields: u32[ceil(n/L)*L/4]; bits: u8[ceil(n/L)].  values_out capacity
// n + L.  Returns values_size.
int64_t flrl_fl_fold(const uint32_t* fields, const uint8_t* bits, int64_t n,
                     int frame_len, uint8_t* values_out) {
  if (n < 0 || frame_len <= 0 || frame_len % 8 != 0) return -1;
  if (n == 0) return 0;
  const int64_t frames = (n + frame_len - 1) / frame_len;
  const int wpf = frame_len / 4;

  int64_t* offs = new int64_t[frames + 1];
  offs[0] = 0;
  for (int64_t f = 0; f < frames; ++f) {
    const int64_t lo = f * frame_len;
    const int64_t hi = lo + frame_len < n ? lo + frame_len : n;
    offs[f + 1] =
        offs[f] + (static_cast<int64_t>(bits[f]) * (hi - lo) + 7) / 8;
  }
  const int64_t values_size = offs[frames];

#pragma omp parallel for schedule(static)
  for (int64_t f = 0; f < frames; ++f) {
    fold_frame(fields + f * wpf, wpf, 4 * bits[f], values_out + offs[f],
               offs[f + 1] - offs[f]);
  }
  delete[] offs;
  return values_size;
}

// Inverse: dense stream -> fields (zero-filled beyond the tail).  Returns 0.
// bits_size bounds the widths array (untrusted container input: a header
// claiming a huge inputSize must not drive reads past the bits buffer).
int flrl_fl_unfold(const uint8_t* values, int64_t values_size,
                   const uint8_t* bits, int64_t bits_size, int64_t n,
                   int frame_len, uint32_t* fields_out) {
  if (n < 0 || frame_len <= 0 || frame_len % 8 != 0) return -1;
  if (n == 0) return 0;
  const int64_t frames = (n + frame_len - 1) / frame_len;
  const int wpf = frame_len / 4;
  if (frames > bits_size) return -4;

  int64_t* offs = new int64_t[frames + 1];
  offs[0] = 0;
  for (int64_t f = 0; f < frames; ++f) {
    const int64_t lo = f * frame_len;
    const int64_t hi = lo + frame_len < n ? lo + frame_len : n;
    if (bits[f] < 1 || bits[f] > 8) { delete[] offs; return -5; }
    offs[f + 1] =
        offs[f] + (static_cast<int64_t>(bits[f]) * (hi - lo) + 7) / 8;
  }
  if (offs[frames] > values_size) { delete[] offs; return -2; }

#pragma omp parallel for schedule(static)
  for (int64_t f = 0; f < frames; ++f) {
    const int b4 = 4 * bits[f];
    const uint64_t fmask = (b4 >= 64) ? ~0ULL : ((1ULL << b4) - 1);
    unfold_frame(values + offs[f], offs[f + 1] - offs[f], wpf, b4, fmask,
                 fields_out + f * wpf);
  }
  delete[] offs;
  return 0;
}

// ---------------------------------------------------------------------------
// RL codec (host fallback)
// ---------------------------------------------------------------------------

namespace {

// Sequential RL emission of the pieces that BEGIN in [lo, hi), given that
// the natural run containing `lo` starts at `run_start` (<= lo) and that
// `lo` is itself a piece boundary.  Piece boundaries are natural run
// starts plus every 255 bytes within a run (the spec's cap,
// IMPLEMENTATION-PLAN.md:125).  The final piece may extend past `hi` (it
// belongs to this range because it begins here).  Pass null outputs for a
// counting dry run.  Returns the number of (count, value) pairs.
// Scan forward while bytes equal v, 8 at a time (u64 compare), then
// byte-wise to the exact boundary.  lim bounds the scan.
static inline int64_t run_scan(const uint8_t* data, int64_t i, int64_t lim,
                               uint8_t v) {
  uint64_t pat;
  memset(&pat, v, sizeof pat);
  int64_t end = i;
  while (end + 8 <= lim) {
    uint64_t w;
    memcpy(&w, data + end, 8);
    if (w != pat) break;
    end += 8;
  }
  while (end < lim && data[end] == v) ++end;
  return end;
}

int64_t rl_emit(const uint8_t* data, int64_t n, int64_t lo, int64_t hi,
                int64_t run_start, uint8_t* counts_out,
                uint8_t* values_out) {
  int64_t r = 0;
  int64_t i = lo;              // invariant: i is a piece boundary
  int64_t start = run_start;   // natural start of the run containing i
  while (i < hi) {
    const uint8_t v = data[i];
    const int64_t cap_end = i + (255 - ((i - start) % 255));
    const int64_t lim = n < cap_end ? n : cap_end;
    const int64_t end = run_scan(data, i, lim, v);
    if (counts_out) {
      counts_out[r] = static_cast<uint8_t>(end - i);
      values_out[r] = v;
    }
    ++r;
    if (end == n) break;
    if (data[end] != v) start = end;   // natural boundary resets the cap
    i = end;
  }
  return r;
}

// Start of the run containing position p (ignoring the 255 cap: the
// natural run start — last j <= p with j == 0 or data[j] != data[j-1]).
int64_t rl_run_start(const uint8_t* data, int64_t p) {
  const uint8_t v = data[p];
  int64_t j = p;
  while (j > 0 && data[j - 1] == v) --j;
  return j;
}

}  // namespace

// counts_out/values_out capacity: n.  Returns run count R.
// Parallel: chunk the input; each chunk emits the pieces that BEGIN in it.
// A chunk's first piece boundary depends on the start of the run crossing
// its left edge — found by a (bounded-in-practice) backward scan; the
// pathological all-one-value input degrades the scan to O(n) for one
// chunk only, the others exit in O(1).
int64_t flrl_rl_encode(const uint8_t* data, int64_t n,
                       uint8_t* counts_out, uint8_t* values_out) {
  if (n <= 0) return 0;
  const int64_t kChunk = 1 << 22;        // 4 MiB, >= 255
  const int64_t nchunks = (n + kChunk - 1) / kChunk;
  if (nchunks == 1) {
    return rl_emit(data, n, 0, n, 0, counts_out, values_out);
  }

  int64_t* rcount = new int64_t[nchunks];
  int64_t* cstart = new int64_t[nchunks];  // first piece boundary >= lo
  int64_t* rstart = new int64_t[nchunks];  // run start governing it

#pragma omp parallel for schedule(dynamic)
  for (int64_t c = 0; c < nchunks; ++c) {
    const int64_t lo = c * kChunk;
    const int64_t hi = lo + kChunk < n ? lo + kChunk : n;
    // The run crossing the left edge starts at s; the first piece
    // boundary >= lo is either its next cap boundary (s + k*255) or the
    // natural start of the next run, whichever comes first.
    const int64_t s = lo == 0 ? 0 : rl_run_start(data, lo);
    const int64_t first_cap = s + ((lo - s + 254) / 255) * 255;
    int64_t first = first_cap;
    int64_t fstart = s;
    if (first_cap > lo) {
      const uint8_t v = data[lo];
      const int64_t lim = first_cap < hi ? first_cap : hi;
      const int64_t t = run_scan(data, lo, lim, v);
      if (t < lim || (t == lim && t < first_cap)) {
        // crossing run ended naturally at t (before its next cap) —
        // if t == hi no piece begins in this chunk at all
        first = t;
        fstart = t;
      }
    }
    if (first >= hi) {
      rcount[c] = 0;
      cstart[c] = hi;
      rstart[c] = fstart;
      continue;
    }
    cstart[c] = first;
    rstart[c] = fstart;
    rcount[c] = rl_emit(data, n, first, hi, fstart, nullptr, nullptr);
  }

  int64_t* roff = new int64_t[nchunks + 1];
  roff[0] = 0;
  for (int64_t c = 0; c < nchunks; ++c) roff[c + 1] = roff[c] + rcount[c];
  const int64_t total = roff[nchunks];

#pragma omp parallel for schedule(dynamic)
  for (int64_t c = 0; c < nchunks; ++c) {
    if (rcount[c] == 0) continue;
    const int64_t lo = cstart[c];
    const int64_t hi = (c + 1) * kChunk < n ? (c + 1) * kChunk : n;
    rl_emit(data, n, lo, hi, rstart[c], counts_out + roff[c],
            values_out + roff[c]);
  }
  delete[] rcount;
  delete[] cstart;
  delete[] rstart;
  delete[] roff;
  return total;
}

// Returns decoded size, or -1 if it would exceed cap.
int64_t flrl_rl_decode(const uint8_t* counts, const uint8_t* values,
                       int64_t r, uint8_t* out, int64_t cap) {
  const int64_t kChunk = 1 << 20;        // runs per chunk
  const int64_t nchunks = (r + kChunk - 1) / kChunk;
  int64_t* sums = new int64_t[nchunks + 1];
  sums[0] = 0;
#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < nchunks; ++c) {
    const int64_t lo = c * kChunk;
    const int64_t hi = lo + kChunk < r ? lo + kChunk : r;
    int64_t s = 0;
    for (int64_t i = lo; i < hi; ++i) s += counts[i];
    sums[c + 1] = s;
  }
  for (int64_t c = 0; c < nchunks; ++c) sums[c + 1] += sums[c];
  const int64_t n = nchunks ? sums[nchunks] : 0;
  if (n > cap) { delete[] sums; return -1; }
#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < nchunks; ++c) {
    const int64_t lo = c * kChunk;
    const int64_t hi = lo + kChunk < r ? lo + kChunk : r;
    int64_t off = sums[c];
    for (int64_t i = lo; i < hi; ++i) {
      memset(out + off, values[i], static_cast<size_t>(counts[i]));
      off += counts[i];
    }
  }
  delete[] sums;
  return n;
}

}  // extern "C"
