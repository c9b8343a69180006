// Asynchronous checkpoint writer: a background worker thread that makes
// snapshot bytes durable (write -> fsync -> atomic rename) off the training
// thread's critical path. The reference's checkpointer serialized on the
// trainer thread (extensions/checkpoint.py (dagger)); on TPU the step cadence
// is milliseconds and disk syncs are not, so snapshot IO must overlap
// training. Bounded queue => backpressure instead of unbounded memory.
//
// C API (ctypes-friendly, mirrors host_comm.cpp conventions):
//   cw_init(queue_depth)              -> opaque handle
//   cw_submit(h, path, data, len)     -> 0 (blocks while queue is full)
//   cw_pending(h)                     -> jobs not yet durable
//   cw_wait(h)                        -> drain; returns #failures since last
//   cw_finalize(h)                    -> drain, join, free

#include <condition_variable>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct Job {
  std::string path;
  std::vector<char> data;
};

struct Writer {
  std::deque<Job> queue;
  std::mutex mu;
  std::condition_variable cv_push;  // worker waits for work
  std::condition_variable cv_done;  // producers wait for space / drain
  size_t max_depth = 4;
  int in_flight = 0;  // queued + currently being written
  int failures = 0;
  bool stop = false;
  std::thread worker;
};

bool write_durable(const Job& job) {
  // tmp file + fsync + rename: a crash mid-write never corrupts an existing
  // snapshot (same protocol as the Python .tmp/os.replace path).
  std::string tmp = job.path + ".tmp_native";
  int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return false;
  const char* p = job.data.data();
  size_t left = job.data.size();
  bool ok = true;
  while (left > 0) {
    ssize_t n = ::write(fd, p, left);
    if (n < 0) {
      ok = false;
      break;
    }
    p += n;
    left -= static_cast<size_t>(n);
  }
  if (ok && ::fsync(fd) != 0) ok = false;
  ::close(fd);
  if (ok && ::rename(tmp.c_str(), job.path.c_str()) != 0) ok = false;
  if (!ok) ::unlink(tmp.c_str());
  return ok;
}

void run(Writer* w) {
  for (;;) {
    Job job;
    {
      std::unique_lock<std::mutex> lk(w->mu);
      w->cv_push.wait(lk, [&] { return w->stop || !w->queue.empty(); });
      if (w->queue.empty()) return;  // stop requested and drained
      job = std::move(w->queue.front());
      w->queue.pop_front();
    }
    // A queue slot just freed: release any backpressured submit NOW, not
    // after the (multi-second) durable write below.
    w->cv_done.notify_all();
    bool ok = write_durable(job);
    {
      std::lock_guard<std::mutex> lk(w->mu);
      if (!ok) w->failures++;
      w->in_flight--;
    }
    w->cv_done.notify_all();
  }
}

}  // namespace

extern "C" {

void* cw_init(int queue_depth) {
  Writer* w = new Writer();
  if (queue_depth > 0) w->max_depth = static_cast<size_t>(queue_depth);
  w->worker = std::thread(run, w);
  return w;
}

int cw_submit(void* h, const char* path, const char* data, long long len) {
  Writer* w = static_cast<Writer*>(h);
  std::unique_lock<std::mutex> lk(w->mu);
  if (w->stop) return -1;
  w->cv_done.wait(lk, [&] { return w->queue.size() < w->max_depth; });
  Job job;
  job.path = path;
  job.data.assign(data, data + len);
  w->queue.push_back(std::move(job));
  w->in_flight++;
  w->cv_push.notify_one();
  return 0;
}

int cw_pending(void* h) {
  Writer* w = static_cast<Writer*>(h);
  std::lock_guard<std::mutex> lk(w->mu);
  return w->in_flight;
}

int cw_wait(void* h) {
  Writer* w = static_cast<Writer*>(h);
  std::unique_lock<std::mutex> lk(w->mu);
  w->cv_done.wait(lk, [&] { return w->in_flight == 0; });
  int f = w->failures;
  w->failures = 0;
  return f;
}

void cw_finalize(void* h) {
  Writer* w = static_cast<Writer*>(h);
  {
    std::unique_lock<std::mutex> lk(w->mu);
    w->cv_done.wait(lk, [&] { return w->in_flight == 0; });
    w->stop = true;
  }
  w->cv_push.notify_all();
  w->worker.join();
  delete w;
}

}  // extern "C"
