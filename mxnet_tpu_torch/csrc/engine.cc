// Dependency engine and pooled host storage of mxnet_tpu_torch.
//
// The host runtime of the reference (SURVEY section 2.1), as a flat C ABI
// loaded with ctypes (mxnet_tpu_torch/engine.py, storage.py):
//  - ThreadedEngine dependency scheduling: versioned vars, ops with
//    const/mutable var sets, per-var waiter FIFOs (the reference's
//    VersionedVarBlock lists, src/engine/threaded_engine.h:120-229),
//    worker thread pools per lane with priorities, async exception
//    capture and propagation to dependent ops' vars
//    (threaded_engine.h:310,466-498)
//  - pooled storage manager: exact-size bucket recycling with stats
//    (reference: src/storage/pooled_storage_manager.h:52-94)
//
// The engine schedules host tasks: record decode, checkpoint writes,
// batch collection. CUDA work an op issues is ordered by the Python side
// (engine.py records an event per op that touches the card). Built with
// g++ -O3 -fPIC -std=c++17 -Wall -shared -lpthread at first use
// (mxnet_tpu_torch/_native.py).
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

using Callback = int (*)(void*);  // user fn: 0 ok, nonzero = failed

struct Op;

struct Var {
  std::deque<std::pair<Op*, bool>> waiters;  // (op, is_write)
  int active_readers = 0;
  bool active_writer = false;
  uint64_t version = 0;
  bool has_error = false;
  int64_t error_op = -1;  // op id that poisoned this var
};

struct Op {
  int64_t id;
  Callback fn;
  void* ctx;
  std::vector<int64_t> const_vars;
  std::vector<int64_t> mutable_vars;
  std::atomic<int> missing{0};  // ungranted deps
  int priority = 0;
  int lane = 0;  // worker-pool lane (ThreadedEnginePerDevice analog:
                 // lane 0 = compute, lane 1 = copy/IO, ...)
  bool always_run = false;  // run even when inputs are poisoned (internal
                            // WaitForVar sync ops must fire their cv)
};

struct OpCmp {
  bool operator()(Op* a, Op* b) const {
    if (a->priority != b->priority) return a->priority < b->priority;
    return a->id > b->id;  // FIFO within priority
  }
};

class Engine {
 public:
  // nlanes worker pools share ONE dependency/var state: the reference's
  // ThreadedEnginePerDevice runs a pool per device plus dedicated copy
  // workers (threaded_engine_perdevice.cc) so slow IO ops can't starve
  // compute ops; the card's work is ordered by CUDA streams, so the
  // lanes that matter are compute vs host-side copy/IO.
  explicit Engine(int nthreads, int nlanes = 1)
      : shutdown_(false), inflight_(0) {
    if (nthreads < 1) nthreads = 1;
    if (nlanes < 1) nlanes = 1;
    ready_.resize(nlanes);
    lane_cv_ = std::vector<std::condition_variable>(nlanes);
    // total thread count honors nthreads (MXNET_CPU_WORKER_NTHREADS):
    // auxiliary lanes (copy/IO) get 1 worker each like the reference's
    // small copy pools, the compute lane keeps the rest. Floor: every
    // lane needs >=1 worker (a zero-worker lane would deadlock its
    // queue), so with nthreads <= nlanes-1 the total is nlanes.
    int aux = nlanes - 1;
    int lane0 = nthreads > aux ? nthreads - aux : 1;
    for (int l = 0; l < nlanes; ++l) {
      int n = (l == 0) ? lane0 : 1;
      for (int i = 0; i < n; ++i)
        workers_.emplace_back([this, l] { WorkerLoop(l); });
    }
  }

  ~Engine() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      shutdown_ = true;
      for (auto& c : lane_cv_) c.notify_all();
    }
    for (auto& t : workers_) t.join();
    for (auto& kv : vars_) delete kv.second;
  }

  int64_t NewVar() {
    std::unique_lock<std::mutex> lk(mu_);
    int64_t id = next_var_++;
    vars_[id] = new Var();
    return id;
  }

  int64_t Push(Callback fn, void* ctx, const int64_t* cvars, int ncon,
               const int64_t* mvars, int nmut, int priority,
               bool always_run = false, int lane = 0) {
    Op* op = new Op();
    std::unique_lock<std::mutex> lk(mu_);
    op->id = next_op_++;
    op->fn = fn;
    op->ctx = ctx;
    op->priority = priority;
    op->lane = (lane >= 0 && lane < static_cast<int>(ready_.size()))
                   ? lane : 0;
    op->always_run = always_run;
    op->const_vars.assign(cvars, cvars + ncon);
    op->mutable_vars.assign(mvars, mvars + nmut);
    op->missing.store(ncon + nmut);
    ++inflight_;
    if (ncon + nmut == 0) {
      Ready(op);
    } else {
      for (int i = 0; i < ncon; ++i)
        vars_[cvars[i]]->waiters.emplace_back(op, false);
      for (int i = 0; i < nmut; ++i)
        vars_[mvars[i]]->waiters.emplace_back(op, true);
      for (int i = 0; i < ncon; ++i) Grant(vars_[cvars[i]]);
      for (int i = 0; i < nmut; ++i) Grant(vars_[mvars[i]]);
    }
    return op->id;
  }

  // blocks until every op that reads or writes `var` (pushed so far) is
  // done; returns the id of the op that poisoned the var, or -1
  int64_t WaitForVar(int64_t var) {
    std::mutex m;
    std::condition_variable c;
    bool done = false;
    struct Sync {
      std::mutex* m;
      std::condition_variable* c;
      bool* done;
    } sync{&m, &c, &done};
    auto cb = [](void* p) -> int {
      Sync* s = static_cast<Sync*>(p);
      std::unique_lock<std::mutex> lk(*s->m);
      *s->done = true;
      s->c->notify_all();
      return 0;
    };
    int64_t v[1] = {var};
    Push(cb, &sync, v, 1, nullptr, 0, 1 << 20, /*always_run=*/true);
    {
      std::unique_lock<std::mutex> lk(m);
      c.wait(lk, [&] { return done; });
    }
    std::unique_lock<std::mutex> lk(mu_);
    Var* vp = vars_[var];
    return vp->has_error ? vp->error_op : -1;
  }

  void WaitForAll() {
    std::unique_lock<std::mutex> lk(mu_);
    all_done_.wait(lk, [&] { return inflight_ == 0; });
  }

  uint64_t Version(int64_t var) {
    std::unique_lock<std::mutex> lk(mu_);
    return vars_[var]->version;
  }

 private:
  // grant queue heads under mu_
  void Grant(Var* v) {
    while (!v->waiters.empty()) {
      Op* op = v->waiters.front().first;
      bool w = v->waiters.front().second;
      if (w) {
        if (v->active_readers == 0 && !v->active_writer) {
          v->active_writer = true;
          v->waiters.pop_front();
          if (op->missing.fetch_sub(1) == 1) Ready(op);
        }
        break;  // a write (granted or not) blocks everything behind it
      }
      if (v->active_writer) break;
      v->active_readers++;
      v->waiters.pop_front();
      if (op->missing.fetch_sub(1) == 1) Ready(op);
    }
  }

  void Ready(Op* op) {  // under mu_
    ready_[op->lane].push(op);
    lane_cv_[op->lane].notify_one();
  }

  void WorkerLoop(int lane) {
    for (;;) {
      Op* op;
      {
        std::unique_lock<std::mutex> lk(mu_);
        lane_cv_[lane].wait(
            lk, [&] { return shutdown_ || !ready_[lane].empty(); });
        if (shutdown_ && ready_[lane].empty()) return;
        op = ready_[lane].top();
        ready_[lane].pop();
        // poisoned inputs? skip execution, propagate to outputs
        bool poisoned = false;
        int64_t src = -1;
        for (int64_t vid : op->const_vars)
          if (vars_[vid]->has_error) { poisoned = true;
            src = vars_[vid]->error_op; break; }
        if (!poisoned)
          for (int64_t vid : op->mutable_vars)
            if (vars_[vid]->has_error) { poisoned = true;
              src = vars_[vid]->error_op; break; }
        if (poisoned && !op->always_run) {
          Complete(op, true, src);
          continue;
        }
      }
      int rc = op->fn(op->ctx);  // run WITHOUT the lock
      {
        std::unique_lock<std::mutex> lk(mu_);
        Complete(op, rc != 0, op->id);
      }
    }
  }

  void Complete(Op* op, bool failed, int64_t err_src) {  // under mu_
    for (int64_t vid : op->const_vars) {
      Var* v = vars_[vid];
      v->active_readers--;
      Grant(v);
    }
    for (int64_t vid : op->mutable_vars) {
      Var* v = vars_[vid];
      v->active_writer = false;
      v->version++;
      if (failed && !v->has_error) {
        v->has_error = true;
        v->error_op = err_src;
      }
      Grant(v);
    }
    delete op;
    if (--inflight_ == 0) all_done_.notify_all();
  }

  std::mutex mu_;
  std::vector<std::condition_variable> lane_cv_;
  std::condition_variable all_done_;
  std::vector<std::priority_queue<Op*, std::vector<Op*>, OpCmp>> ready_;
  std::unordered_map<int64_t, Var*> vars_;
  std::vector<std::thread> workers_;
  int64_t next_var_ = 0;
  int64_t next_op_ = 0;
  bool shutdown_;
  int inflight_;
};

// ------------------------------------------------------- pooled storage --

class PooledStorage {
 public:
  // strategy + cap knobs (reference: pooled_storage_manager.h
  // GPUPooledStorageManager [Round strategy, pow2 rounding with linear
  // cutoff] / GPUPooledRoundedStorageManager, MXNET_GPU_MEM_POOL_TYPE /
  // _RESERVE — the card's memory belongs to torch's caching allocator,
  // so the knobs steer this host pool)
  enum Strategy { kNaive = 0, kRound = 1, kUnpooled = 2 };

  explicit PooledStorage(int strategy = kNaive,
                         int64_t max_pooled_bytes = -1)
      : strategy_(strategy), max_pooled_bytes_(max_pooled_bytes) {}

  void* Alloc(size_t size) {
    if (strategy_ == kUnpooled) {
      void* p = malloc(size);
      if (!p) return nullptr;
      std::unique_lock<std::mutex> lk(mu_);
      used_bytes_ += size;
      total_allocs_++;
      sizes_[p] = size;
      return p;
    }
    size = RoundUp(size);
    {
      std::unique_lock<std::mutex> lk(mu_);
      auto it = pool_.find(size);
      if (it != pool_.end() && !it->second.empty()) {
        void* p = it->second.back();
        it->second.pop_back();
        pooled_bytes_ -= size;
        used_bytes_ += size;
        sizes_[p] = size;
        return p;
      }
    }
    void* p = malloc(size);
    if (!p) return nullptr;
    std::unique_lock<std::mutex> lk(mu_);
    used_bytes_ += size;
    total_allocs_++;
    sizes_[p] = size;
    return p;
  }

  void Free(void* p) {  // returns to the pool
    std::unique_lock<std::mutex> lk(mu_);
    auto it = sizes_.find(p);
    if (it == sizes_.end()) return;
    size_t size = it->second;
    sizes_.erase(it);
    used_bytes_ -= size;
    if (strategy_ == kUnpooled ||
        (max_pooled_bytes_ >= 0 &&
         pooled_bytes_ + size > static_cast<size_t>(max_pooled_bytes_))) {
      free(p);  // over the reserve cap: give it back to the OS
      return;
    }
    pooled_bytes_ += size;
    pool_[size].push_back(p);
  }

  void DirectFree(void* p) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = sizes_.find(p);
    if (it != sizes_.end()) {
      used_bytes_ -= it->second;
      sizes_.erase(it);
    }
    free(p);
  }

  void ReleaseAll() {
    std::unique_lock<std::mutex> lk(mu_);
    for (auto& kv : pool_)
      for (void* p : kv.second) free(p);
    pool_.clear();
    pooled_bytes_ = 0;
  }

  void Stats(int64_t* out) {
    std::unique_lock<std::mutex> lk(mu_);
    out[0] = static_cast<int64_t>(used_bytes_);
    out[1] = static_cast<int64_t>(pooled_bytes_);
    out[2] = static_cast<int64_t>(total_allocs_);
  }

 private:
  size_t RoundUp(size_t s) const {
    if (strategy_ == kRound) {
      // pow2 rounding above a linear cutoff (GPUPooledRounded semantics)
      const size_t kCutoff = 1u << 14;
      if (s <= kCutoff) return (s + 63) / 64 * 64;
      size_t r = kCutoff;
      while (r < s) r <<= 1;
      return r;
    }
    // kNaive: page-round large, 64B-round small (exact-size buckets)
    const size_t kPage = 4096;
    if (s >= kPage) return (s + kPage - 1) / kPage * kPage;
    size_t r = 64;
    while (r < s) r <<= 1;
    return r;
  }

  const int strategy_;
  const int64_t max_pooled_bytes_;

  std::mutex mu_;
  std::unordered_map<size_t, std::vector<void*>> pool_;
  std::unordered_map<void*, size_t> sizes_;
  size_t used_bytes_ = 0;
  size_t pooled_bytes_ = 0;
  size_t total_allocs_ = 0;
};

}  // namespace

extern "C" {

void* eng_create(int nthreads) { return new Engine(nthreads); }
void eng_destroy(void* h) { delete static_cast<Engine*>(h); }
int64_t eng_new_var(void* h) { return static_cast<Engine*>(h)->NewVar(); }

int64_t eng_push(void* h, Callback fn, void* ctx, const int64_t* cvars,
                 int ncon, const int64_t* mvars, int nmut, int priority) {
  return static_cast<Engine*>(h)->Push(fn, ctx, cvars, ncon, mvars, nmut,
                                       priority);
}

// ThreadedEnginePerDevice analog: nlanes independent worker pools over
// one dependency state; lane selects the pool (0 = compute, 1 = copy/IO)
void* eng_create_lanes(int nthreads, int nlanes) {
  return new Engine(nthreads, nlanes);
}

int64_t eng_push_lane(void* h, Callback fn, void* ctx,
                      const int64_t* cvars, int ncon, const int64_t* mvars,
                      int nmut, int priority, int lane) {
  return static_cast<Engine*>(h)->Push(fn, ctx, cvars, ncon, mvars, nmut,
                                       priority, /*always_run=*/false,
                                       lane);
}

int64_t eng_wait_for_var(void* h, int64_t var) {
  return static_cast<Engine*>(h)->WaitForVar(var);
}

void eng_wait_all(void* h) { static_cast<Engine*>(h)->WaitForAll(); }

uint64_t eng_var_version(void* h, int64_t var) {
  return static_cast<Engine*>(h)->Version(var);
}

void* pool_create() { return new PooledStorage(); }
void* pool_create2(int strategy, int64_t max_pooled_bytes) {
  return new PooledStorage(strategy, max_pooled_bytes);
}
void pool_destroy(void* h) {
  static_cast<PooledStorage*>(h)->ReleaseAll();
  delete static_cast<PooledStorage*>(h);
}
void* pool_alloc(void* h, int64_t size) {
  return static_cast<PooledStorage*>(h)->Alloc(
      static_cast<size_t>(size));
}
void pool_free(void* h, void* p) { static_cast<PooledStorage*>(h)->Free(p); }
void pool_direct_free(void* h, void* p) {
  static_cast<PooledStorage*>(h)->DirectFree(p);
}
void pool_release_all(void* h) {
  static_cast<PooledStorage*>(h)->ReleaseAll();
}
void pool_stats(void* h, int64_t* out) {
  static_cast<PooledStorage*>(h)->Stats(out);
}

}  // extern "C"
