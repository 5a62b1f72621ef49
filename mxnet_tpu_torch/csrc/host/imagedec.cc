// Native threaded JPEG decode + resize for the input pipeline: the port's
// own copy of mxnet_tpu/_native/imagedec.cc, built by
// mxnet_tpu_torch/io_native.py.
//
// The host-side equivalent of the reference's OMP-parallel OpenCV decode loop
// inside `src/io/iter_image_recordio_2.cc:799` (SURVEY hard-part #8): the
// ImageNet-scale bottleneck is host JPEG decode, which must run native and
// parallel — a Python/PIL loop is GIL-bound.  Uses libjpeg(-turbo) with
// DCT scaling (scale_denom) so large photos downscale during decode, then
// a fixed bilinear resize to the target shape so a whole batch lands in
// one contiguous HWC uint8 buffer.
//
// Flat C ABI for ctypes, same boundary style as recordio.cc.
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode one JPEG into RGB (or gray) and bilinear-resize to (oh, ow).
// fast != 0 selects JDCT_IFAST + plain chroma upsampling: ~10% faster,
// luma error ~1 LSB, chroma error a few levels at sharp color edges —
// fine for augmented training input; pass 0 for exact ISLOW decode
// (eval/tests).  Returns 0 on success.
int DecodeOne(const uint8_t* buf, size_t len, int oh, int ow, int channels,
              int fast, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  // declared BEFORE setjmp: longjmp skips C++ unwinding, so the buffer
  // must live in the frame that survives the jump and is destroyed on the
  // normal return path either way (no leak on mid-decode failures)
  std::vector<uint8_t> img;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.out_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  // DCT scaling: pick the largest 1/N (N in 1,2,4,8) that stays >= target
  unsigned denom = 1;
  while (denom < 8 &&
         cinfo.image_width / (denom * 2) >= static_cast<unsigned>(ow) &&
         cinfo.image_height / (denom * 2) >= static_cast<unsigned>(oh)) {
    denom *= 2;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  if (fast) {
    cinfo.dct_method = JDCT_IFAST;
    cinfo.do_fancy_upsampling = FALSE;
  }
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  const int c = cinfo.output_components;
  img.resize(static_cast<size_t>(w) * h * c);
  // hand libjpeg a window of row pointers per call (rec_outbuf_height)
  // instead of one scanline at a time
  JSAMPROW rows[8];
  const int rec = std::min<int>(8, std::max<int>(1, cinfo.rec_outbuf_height));
  while (cinfo.output_scanline < cinfo.output_height) {
    const unsigned base = cinfo.output_scanline;
    const int nrows = std::min<unsigned>(rec, cinfo.output_height - base);
    for (int r = 0; r < nrows; ++r)
      rows[r] = img.data() + static_cast<size_t>(base + r) * w * c;
    jpeg_read_scanlines(&cinfo, rows, nrows);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  if (w == ow && h == oh && c == channels) {
    std::memcpy(out, img.data(), img.size());
    return 0;
  }
  // bilinear resize to (oh, ow); channel count already matches colorspace
  const float sx = static_cast<float>(w) / ow;
  const float sy = static_cast<float>(h) / oh;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = std::max(0, std::min(h - 1, static_cast<int>(fy)));
    int y1 = std::min(h - 1, y0 + 1);
    float wy = std::max(0.0f, std::min(1.0f, fy - y0));
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = std::max(0, std::min(w - 1, static_cast<int>(fx)));
      int x1 = std::min(w - 1, x0 + 1);
      float wx = std::max(0.0f, std::min(1.0f, fx - x0));
      for (int ch = 0; ch < channels; ++ch) {
        int cc = std::min(ch, c - 1);
        float v00 = img[(static_cast<size_t>(y0) * w + x0) * c + cc];
        float v01 = img[(static_cast<size_t>(y0) * w + x1) * c + cc];
        float v10 = img[(static_cast<size_t>(y1) * w + x0) * c + cc];
        float v11 = img[(static_cast<size_t>(y1) * w + x1) * c + cc];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        out[(static_cast<size_t>(y) * ow + x) * channels + ch] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
  return 0;
}

// Persistent decode pool (reference `iter_image_recordio_2.cc` keeps its
// OMP team alive across batches; our previous per-batch std::thread spawn
// paid thread creation + teardown on every batch — measurable at bs32
// where a batch decodes in a few ms).  Workers are created once, lazily,
// and park on a condition variable between batches; each batch is one
// BatchJob whose items are claimed via an atomic ticket.  Per-job
// parallelism is still capped by the caller's nthreads (participation
// tickets), so a 1-thread request decodes on the caller thread alone and
// thread-scaling measurements stay meaningful.
struct BatchJob {
  const uint8_t** bufs;
  const size_t* lens;
  int n, oh, ow, channels, fast;
  uint8_t* out;
  int* errs;
  size_t stride;
  int max_workers;               // per-job parallelism cap (incl. caller)
  std::atomic<int> claimed{0};   // participation tickets handed out
  std::atomic<int> next{0};      // next item index to decode
  std::atomic<int> completed{0};
  std::atomic<int> nbad{0};
};

class DecodePool {
 public:
  static DecodePool& Get() {
    // leaked on purpose: parked workers must outlive static destruction
    static DecodePool* pool = new DecodePool();
    return *pool;
  }

  // The job is heap-shared: a worker that wakes late still holds a live
  // reference after Run returned, sees every item already claimed, and
  // exits without touching the caller's buffers.
  int Run(std::shared_ptr<BatchJob> job) {
    // one batch at a time through the shared pool: concurrent callers
    // (two iterators) serialize here instead of corrupting the job slot
    std::lock_guard<std::mutex> run_lk(run_mu_);
    if (job->max_workers > 1 && job->n > 1) {
      EnsureThreads(job->max_workers - 1);  // caller participates too
      {
        std::lock_guard<std::mutex> lk(mu_);
        job_ = job;
        ++seq_;
      }
      cv_.notify_all();
    }
    Work(*job);
    if (job->completed.load() < job->n) {
      std::unique_lock<std::mutex> lk(done_mu_);
      done_cv_.wait(lk, [&] { return job->completed.load() >= job->n; });
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (job_ == job) job_.reset();
    }
    batches_.fetch_add(1);
    return job->nbad.load();
  }

  int NumThreads() {
    std::lock_guard<std::mutex> lk(mu_);
    return static_cast<int>(threads_.size());
  }
  long BatchesServed() { return batches_.load(); }
  long ThreadsSpawned() { return spawned_.load(); }

 private:
  void EnsureThreads(int want) {
    want = std::min(want, 64);  // oversubscription cap
    std::lock_guard<std::mutex> lk(mu_);
    while (static_cast<int>(threads_.size()) < want) {
      threads_.emplace_back([this] { WorkerLoop(); });
      threads_.back().detach();  // pool is immortal; see Get()
      spawned_.fetch_add(1);
    }
  }

  void WorkerLoop() {
    uint64_t seen = 0;
    for (;;) {
      std::shared_ptr<BatchJob> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return seq_ != seen; });
        seen = seq_;
        job = job_;  // shared_ptr copy: safe even if Run returns first
      }
      if (job) Work(*job);
    }
  }

  void Work(BatchJob& job) {
    if (job.claimed.fetch_add(1) >= job.max_workers) return;
    for (;;) {
      int i = job.next.fetch_add(1);
      if (i >= job.n) break;
      int rc = DecodeOne(job.bufs[i], job.lens[i], job.oh, job.ow,
                         job.channels, job.fast, job.out + job.stride * i);
      job.errs[i] = rc;
      if (rc) job.nbad.fetch_add(1);
      if (job.completed.fetch_add(1) + 1 == job.n) {
        std::lock_guard<std::mutex> lk(done_mu_);
        done_cv_.notify_all();
      }
    }
  }

  std::mutex run_mu_;              // serializes batches through the pool
  std::mutex mu_;                  // guards job_/seq_/threads_
  std::condition_variable cv_;     // workers park here between batches
  std::mutex done_mu_;
  std::condition_variable done_cv_;
  std::shared_ptr<BatchJob> job_;
  uint64_t seq_ = 0;
  std::vector<std::thread> threads_;
  std::atomic<long> batches_{0};
  std::atomic<long> spawned_{0};
};

}  // namespace

extern "C" {

// Decode n JPEGs in parallel into out[n, oh, ow, channels] (HWC uint8).
// errs[i] = 0 ok / 1 decode failure.  nthreads <= 0 -> hardware count.
// fast != 0 -> IFAST DCT + plain upsampling (see DecodeOne).
// Runs on the persistent DecodePool: no per-batch thread creation.
int MXTPUDecodeJpegBatchEx(const uint8_t** bufs, const size_t* lens, int n,
                           int oh, int ow, int channels, uint8_t* out,
                           int nthreads, int fast, int* errs) {
  if (n <= 0) return 0;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (nthreads <= 0) nthreads = hw > 0 ? hw : 1;
  nthreads = std::min(nthreads, n);
  auto job = std::make_shared<BatchJob>();
  job->bufs = bufs;
  job->lens = lens;
  job->n = n;
  job->oh = oh;
  job->ow = ow;
  job->channels = channels;
  job->fast = fast;
  job->out = out;
  job->errs = errs;
  job->stride = static_cast<size_t>(oh) * ow * channels;
  job->max_workers = nthreads;
  return DecodePool::Get().Run(std::move(job));
}

// Pool introspection: persistent worker count, total batches served, and
// total threads ever created.  `spawned` staying flat while `batches`
// grows is the observable proof that no thread is created per batch.
int MXTPUDecodePoolThreads() { return DecodePool::Get().NumThreads(); }
long MXTPUDecodePoolBatches() { return DecodePool::Get().BatchesServed(); }
long MXTPUDecodePoolSpawned() { return DecodePool::Get().ThreadsSpawned(); }

// Back-compat entry (exact ISLOW decode).
int MXTPUDecodeJpegBatch(const uint8_t** bufs, const size_t* lens, int n,
                         int oh, int ow, int channels, uint8_t* out,
                         int nthreads, int* errs) {
  return MXTPUDecodeJpegBatchEx(bufs, lens, n, oh, ow, channels, out,
                                nthreads, /*fast=*/0, errs);
}

}  // extern "C"
