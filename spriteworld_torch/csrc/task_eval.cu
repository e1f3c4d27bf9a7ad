// A task tree's reward, success and validity for Hopper (sm_90a): factors
// in, reward f32[B], success bool[B] and validity bool[B] out, in one
// launch.
//
// What it replaces. No pallas_call: the JAX package evaluates its tasks in
// XLA (spriteworld_tpu/core/tasks.py, FindGoalPosition, Clustering and
// MetaAggregated, with the Davies-Bouldin index of
// spriteworld_tpu/ops/clustering.py), which fuses each into a few
// kernels. The port's plain twin is the tasks' own methods
// (spriteworld_torch/core/tasks.py and ops/clustering.py): a few dozen
// small PyTorch kernels a node, each a launch of ~1.5 us on the card, and
// a step evaluates the task three times (the transition's reward, success
// and validity, the fresh scene's validity, the render's success): about
// 340 launches a sorting step, 560 at the compositional example. This
// kernel evaluates a whole tree, for all three outputs, in one launch.
//
// The tree comes as a table (spriteworld_torch/ops/task_eval.py documents
// the layout; core.tasks.task_table builds it once): task nodes in
// postfix order, then predicate programs, postfix programs over one
// sprite's factors that the filters and cluster distributions compile to
// (Continuous, Discrete, Product, Intersection, Mixture, SetMinus,
// Selection). The block copies the table into shared memory; a warp
// walks it with a stack of (reward, success, valid) entries for the task
// nodes, and a thread runs a predicate program with a 32-bit stack of
// results.
//
// What bounds it. It reads the factors once, f32[B, K, 10]: 0.98 MB at
// the compositional example's 2048 lanes x 12 slots (0.3 us at 3.35 TB/s),
// and writes six bytes a lane. Its arithmetic (a predicate program and a
// float64 square root a filtered sprite, a Davies-Bouldin index of K
// slots and C clusters a lane) is smaller still. At the sizes a step
// evaluates, the launch and each warp's chain of dependent operations are
// its time.
//
// Design. One warp a lane, thread t holding sprite slot t (K <= 32). A
// first design with one thread a lane walked every slot in turn and took
// 57 us a launch at the compositional example's 2048 lanes x 12 slots, 9
// us at sorting's (H100, in a graph): 64 warps on 16 SMs, each thread a
// long chain of dependent table reads, predicate programs and float64
// roots. Here a thread runs the predicates, the goal distance and the
// cluster spread of its own slot, and each warp keeps the result of every
// node in all its threads alike: a sum over the slots is the twin's left
// fold in slot order (`ops.clustering.ordered_sum`), the terms read from
// the slots' threads by __shfl_sync in index order; a count, an "any" or
// an "all" over the slots is a __ballot_sync, __any_sync or __all_sync.
// Clusters and subtasks are loops in index order that every thread runs
// alike, and thread t < C * C computes the cluster pair (t / C, t % C)
// (C <= 5). A cluster's members are one 32-bit ballot, the first cluster
// whose distribution contains a sprite taking it. The table is read from
// shared memory. So a launch takes ~11 us at the compositional example
// and ~6 at sorting, ~2.5 of it for a launch that evaluates nothing.
// Neither fewer threads a lane (2 at sorting, 16 lanes a warp) nor the
// factor rows staged in shared memory moved it: each warp's chain of
// dependent operations bounds it, not the instructions the warps issue or
// the loads.
//
// Rounding. The twin runs one eager operator at a time and each rounds
// once, so every float operation here is one IEEE operation with an
// explicit rounding (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), which
// nvcc never contracts into a fused multiply-add, in the twin's order.
// Python scalars enter as float32 (the table holds their float32 bits), as
// they enter torch's float32 operators. Square roots are taken in float64
// and rounded once, as `_per_sprite_rewards` and `clustering._norm` do. A
// Clustering's metric is reciprocal(db) * 1.0 (torch's 1.0 / x), its
// dense reward (metric - threshold) * range * 0.5 (torch on the card
// divides by a Python scalar through its reciprocal). NaN results keep
// the twin's: a select of torch.nan writes kNanBits, and arithmetic on the
// card writes the card's NaN, as the twin's operators do. The edge values
// are the twin's: NaN reward and vacuous success on an empty filter; the
// Davies-Bouldin index 0 at sklearn's atol checks, NaN below 2 clusters
// and 1/0 = inf on all-singleton clusters; NaN-ignoring aggregation. So
// the outputs equal the twin's bit for bit (tests/test_torch_task_eval.py;
// chip_smoke.py's `kernels` line).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kAllThreads = 0xFFFFFFFFu;
constexpr int kHeader = 2;
constexpr int kMaxSlots = 32;
constexpr int kMaxClusters = 5;  // nc * nc pairs on a warp
constexpr int kMaxTaskDepth = 8;
constexpr int kMaxWords = 4096;
// Task nodes and their widths in words.
constexpr int kGoal = 1, kCluster = 2, kNoReward = 3, kMeta = 4;
constexpr int kGoalWords = 10, kClusterWords = 6, kMetaWords = 6;
// Predicate operations.
constexpr int kEnd = 0, kTrue = 1, kContinuous = 2, kDiscrete = 3,
              kAll = 4, kAny = 5, kAndNot = 6;
static_assert(kEnd == 0 && kMeta == 4, "the opcodes of ops/task_eval.py");
// MetaAggregated's aggregators and criteria.
constexpr int kSum = 0, kMax = 1;
constexpr int kCriterionAll = 0;
// float32(1e-8): the atol of np.allclose in sklearn's zero checks.
constexpr float kAtol = 1e-8f;
// torch.nan as float32, as a select or a fill writes it.
constexpr unsigned kNanBits = 0x7fc00000u;

struct Value {
  float reward;
  bool success;
  bool valid;
};

// One lane's warp: thread t's slot, its factors and position, the lane's
// live count and slot count.
struct Slot {
  int t;
  const float* f;
  bool live;
  float x, y;
  int k_max;
};

__device__ __forceinline__ float word_f(int w) { return __int_as_float(w); }

__device__ __forceinline__ float twin_nan() {
  return __uint_as_float(kNanBits);
}

// torch's NaN-propagating maximum (amax).
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// The float32 of sqrt(x) taken in float64.
__device__ __forceinline__ float root(float x) {
  return __double2float_rn(sqrt(static_cast<double>(x)));
}

// ((v_0 + v_1) + v_2) + ... over the lane's k_max slots, v_k thread k's
// `v`, the same in every thread.
__device__ __forceinline__ float fold(float v, int k_max) {
  float acc = __shfl_sync(kAllThreads, v, 0);
  for (int k = 1; k < k_max; ++k)
    acc = __fadd_rn(acc, __shfl_sync(kAllThreads, v, k));
  return acc;
}

// Whether one sprite's factors `f` pass the predicate program at `pc`.
__device__ __forceinline__ bool contains(const int* t, int pc,
                                         const float* f) {
  unsigned stack = 0u;
  for (;;) {
    const int op = t[pc];
    unsigned bit;
    if (op == kTrue) {
      bit = 1u;
      pc += 1;
    } else if (op == kContinuous) {
      const float v = __ldg(f + t[pc + 1]);
      bit = (v >= word_f(t[pc + 2])) & (v < word_f(t[pc + 3]));
      pc += 4;
    } else if (op == kDiscrete) {
      const float v = __ldg(f + t[pc + 1]);
      const int n = t[pc + 2];
      bit = 0u;
      for (int i = 0; i < n; ++i) bit |= v == word_f(t[pc + 3 + i]);
      pc += 3 + n;
    } else if (op == kAll || op == kAny) {
      const int n = t[pc + 1];
      const unsigned mask = (1u << n) - 1u;
      const unsigned top = stack & mask;
      bit = op == kAll ? top == mask : top != 0u;
      stack >>= n;
      pc += 2;
    } else if (op == kAndNot) {
      bit = (stack >> 1) & ~stack & 1u;
      stack >>= 2;
      pc += 1;
    } else {  // kEnd
      return stack & 1u;
    }
    stack = (stack << 1) | bit;
  }
}

// FindGoalPosition: the reward and success of the filtered live sprites
// (`need`), always valid.
__device__ Value goal(const int* t, int pc, const Slot& s, bool need) {
  Value out{0.0f, true, true};
  if (!need) return out;
  const float gx = word_f(t[pc + 2]), gy = word_f(t[pc + 3]);
  const float wx = word_f(t[pc + 4]), wy = word_f(t[pc + 5]);
  const float distance = word_f(t[pc + 6]), mult = word_f(t[pc + 7]);
  const float bonus = word_f(t[pc + 8]);
  const bool sparse = t[pc + 9] != 0;
  const bool in = s.live && contains(t, t[pc + 1], s.f);
  float term = 0.0f;
  if (in) {
    const float dx = __fsub_rn(s.x, gx), dy = __fsub_rn(s.y, gy);
    const float sq = __fadd_rn(__fmul_rn(wx, __fmul_rn(dx, dx)),
                               __fmul_rn(wy, __fmul_rn(dy, dy)));
    term = __fmul_rn(mult, __fsub_rn(distance, root(sq)));
  }
  const float dense = fold(term, s.k_max);
  const bool any = __any_sync(kAllThreads, in);
  const bool ok = __all_sync(kAllThreads, !in || term >= 0.0f);
  out.success = ok;
  out.reward = !any ? twin_nan()
               : ok ? __fadd_rn(dense, bonus)
                    : (sparse ? 0.0f : dense);
  return out;
}

// The Davies-Bouldin index of the lane's nc clusters, `first` the cluster
// of thread t's slot (-1 for none) and `member` each cluster's ballot:
// ops/clustering.py's davies_bouldin_index, operation for operation. The
// centroids, spreads, presence and counts are held alike in every thread;
// thread t < nc * nc computes the pair (t / nc, t % nc).
__device__ float davies_bouldin(const unsigned* member, int nc, int first,
                                const Slot& s) {
  float cx[kMaxClusters], cy[kMaxClusters], intra[kMaxClusters];
  float safe[kMaxClusters], tx[kMaxClusters], ty[kMaxClusters];
  bool present[kMaxClusters];
  int num_present = 0;
  // Centroids: the folds over every slot of member * position.
#pragma unroll
  for (int c = 0; c < kMaxClusters; ++c) {
    if (c < nc) {
      const float count = static_cast<float>(__popc(member[c]));
      present[c] = member[c] != 0u;
      num_present += present[c];
      safe[c] = count < 1.0f ? 1.0f : count;
      const float m = first == c ? 1.0f : 0.0f;
      tx[c] = __fmul_rn(m, s.x);
      ty[c] = __fmul_rn(m, s.y);
      cx[c] = __shfl_sync(kAllThreads, tx[c], 0);
      cy[c] = __shfl_sync(kAllThreads, ty[c], 0);
    }
  }
  for (int k = 1; k < s.k_max; ++k) {
#pragma unroll
    for (int c = 0; c < kMaxClusters; ++c) {
      if (c < nc) {
        cx[c] = __fadd_rn(cx[c], __shfl_sync(kAllThreads, tx[c], k));
        cy[c] = __fadd_rn(cy[c], __shfl_sync(kAllThreads, ty[c], k));
      }
    }
  }
  // Spreads: the folds of distance * member. A slot outside the cluster
  // adds 0 * sqrt(sq), which is 0 * sq (both 0 where sq is finite, the
  // card's NaN where it is not), so a thread takes one root: its own
  // cluster's.
  float sq_own = 0.0f;
#pragma unroll
  for (int c = 0; c < kMaxClusters; ++c) {
    if (c < nc) {
      cx[c] = __fdiv_rn(cx[c], safe[c]);
      cy[c] = __fdiv_rn(cy[c], safe[c]);
      const float ex = __fsub_rn(s.x, cx[c]), ey = __fsub_rn(s.y, cy[c]);
      tx[c] = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
      if (first == c) sq_own = tx[c];
    }
  }
  const float own = __fmul_rn(root(sq_own), 1.0f);
#pragma unroll
  for (int c = 0; c < kMaxClusters; ++c) {
    if (c < nc) {
      tx[c] = first == c ? own : __fmul_rn(0.0f, tx[c]);
      intra[c] = __shfl_sync(kAllThreads, tx[c], 0);
    }
  }
  for (int k = 1; k < s.k_max; ++k) {
#pragma unroll
    for (int c = 0; c < kMaxClusters; ++c) {
      if (c < nc)
        intra[c] = __fadd_rn(intra[c], __shfl_sync(kAllThreads, tx[c], k));
    }
  }
  bool intra_zero = true;
  // Thread c's cluster, for the pairs.
  float own_x = 0.0f, own_y = 0.0f, own_intra = 0.0f;
  int own_present = 0;
#pragma unroll
  for (int c = 0; c < kMaxClusters; ++c) {
    if (c < nc) {
      intra[c] = __fdiv_rn(intra[c], safe[c]);
      intra_zero = intra_zero && intra[c] <= kAtol;
      if (s.t == c) {
        own_x = cx[c];
        own_y = cy[c];
        own_intra = intra[c];
        own_present = present[c];
      }
    }
  }
  const int i = s.t / nc, j = s.t % nc;
  const float xi = __shfl_sync(kAllThreads, own_x, i);
  const float xj = __shfl_sync(kAllThreads, own_x, j);
  const float yi = __shfl_sync(kAllThreads, own_y, i);
  const float yj = __shfl_sync(kAllThreads, own_y, j);
  const float si = __shfl_sync(kAllThreads, own_intra, i);
  const float sj = __shfl_sync(kAllThreads, own_intra, j);
  // Both shuffles run in every thread: a && would skip the second in some.
  const int pi = __shfl_sync(kAllThreads, own_present, i);
  const int pj = __shfl_sync(kAllThreads, own_present, j);
  const bool pair = pi && pj;
  float v = 0.0f;
  bool cd_zero = true;
  if (s.t < nc * nc) {
    const float ex = __fsub_rn(xi, xj), ey = __fsub_rn(yi, yj);
    const float cd = root(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)));
    cd_zero = cd <= kAtol || !(pair && i != j);
    const float ratio =
        __fdiv_rn(__fadd_rn(si, sj), cd == 0.0f ? INFINITY : cd);
    v = pair ? ratio : 0.0f;
  }
  const bool cdist_zero = __all_sync(kAllThreads, cd_zero);
  // Each cluster's score, the maximum over its pairs, and their fold.
  float total = 0.0f;
  for (int a = 0; a < nc; ++a) {
    float score = __shfl_sync(kAllThreads, v, a * nc);
    for (int b = 1; b < nc; ++b)
      score = nan_max(score, __shfl_sync(kAllThreads, v, a * nc + b));
    total = a == 0 ? score : __fadd_rn(total, score);
  }
  float db = __fdiv_rn(total, static_cast<float>(
                                  num_present < 1 ? 1 : num_present));
  if (intra_zero || cdist_zero) db = 0.0f;
  return num_present >= 2 ? db : twin_nan();
}

// Clustering: validity from the memberships, reward and success from
// 1 / davies_bouldin (`need`).
__device__ Value cluster(const int* t, int pc, const Slot& s, bool need) {
  const int nc = t[pc + 1];
  const float threshold = word_f(t[pc + 2]), bonus = word_f(t[pc + 3]);
  const float range = word_f(t[pc + 4]);
  const bool sparse = t[pc + 5] != 0;
  int first = -1;
  if (s.live) {
    for (int c = 0; c < nc; ++c) {
      if (contains(t, t[pc + kClusterWords + c], s.f)) {
        first = c;
        break;
      }
    }
  }
  unsigned member[kMaxClusters];
  int labels = 0, samples = 0;
#pragma unroll
  for (int c = 0; c < kMaxClusters; ++c) {
    member[c] = c < nc ? __ballot_sync(kAllThreads, first == c) : 0u;
    labels += member[c] != 0u;
    samples += __popc(member[c]);
  }
  Value out{0.0f, false, labels >= 2 && labels < samples};
  if (!need) return out;
  const float db = davies_bouldin(member, nc, first, s);
  const float metric = __fmul_rn(__fdiv_rn(1.0f, db), 1.0f);
  const float dense =
      __fmul_rn(__fmul_rn(__fsub_rn(metric, threshold), range), 0.5f);
  out.success = metric >= threshold;
  out.reward = out.success ? __fadd_rn(dense, bonus)
                           : (sparse ? 0.0f : dense);
  return out;
}

// MetaAggregated over its n subtasks' values `kids`, in their order.
__device__ Value meta(const int* t, int pc, const Value* kids, int n,
                      bool need) {
  Value out{0.0f, false, true};
  for (int i = 0; i < n; ++i) out.valid = out.valid && kids[i].valid;
  if (!need) return out;
  const int aggregator = t[pc + 2];
  const bool all = t[pc + 3] == kCriterionAll;
  bool success = all;
  for (int i = 0; i < n; ++i)
    success = all ? success && kids[i].success : success || kids[i].success;
  float agg;
  if (aggregator == kSum) {
    agg = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float r = isnan(kids[i].reward) ? 0.0f : kids[i].reward;
      agg = i == 0 ? r : __fadd_rn(agg, r);
    }
  } else {
    const bool largest = aggregator == kMax;
    bool every_nan = true;
    agg = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float r = kids[i].reward;
      every_nan = every_nan && isnan(r);
      const float clean = isnan(r) ? (largest ? -INFINITY : INFINITY) : r;
      agg = i == 0 ? clean : (largest ? fmaxf(agg, clean)
                                      : fminf(agg, clean));
    }
    if (every_nan) agg = twin_nan();
  }
  if (t[pc + 4] != 0)
    agg = __fadd_rn(agg, __fmul_rn(word_f(t[pc + 5]),
                                   success ? 1.0f : 0.0f));
  out.reward = agg;
  out.success = success;
  return out;
}

__global__ void __launch_bounds__(kThreads) task_eval_kernel(
    const float* __restrict__ factors, long long fstride_b,
    long long fstride_k, const int* __restrict__ num_sprites,
    long long nstride, const int* __restrict__ words, int n_words,
    int batch, int k_max, float* __restrict__ reward,
    unsigned char* __restrict__ success, unsigned char* __restrict__ valid) {
  extern __shared__ int table[];
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) table[i] = words[i];
  __syncthreads();
  const long long lane =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (lane >= batch) return;  // the whole warp
  Slot s;
  s.t = threadIdx.x % 32;
  s.k_max = k_max;
  s.f = factors + lane * fstride_b + s.t * fstride_k;
  s.live = s.t < k_max && s.t < __ldg(num_sprites + lane * nstride);
  s.x = s.t < k_max ? __ldg(s.f) : 0.0f;
  s.y = s.t < k_max ? __ldg(s.f + 1) : 0.0f;
  const bool need = reward != nullptr || success != nullptr;
  Value stack[kMaxTaskDepth];
  int sp = 0, pc = kHeader;
  const int nodes = table[0];
  for (int i = 0; i < nodes; ++i) {
    const int op = table[pc];
    if (op == kGoal) {
      stack[sp++] = goal(table, pc, s, need);
      pc += kGoalWords;
    } else if (op == kCluster) {
      stack[sp++] = cluster(table, pc, s, need);
      pc += kClusterWords + table[pc + 1];
    } else if (op == kNoReward) {
      stack[sp++] = Value{0.0f, false, true};
      pc += 1;
    } else {  // kMeta
      const int n = table[pc + 1];
      sp -= n;
      stack[sp] = meta(table, pc, stack + sp, n, need);
      ++sp;
      pc += kMetaWords;
    }
  }
  if (s.t != 0) return;
  if (reward != nullptr) reward[lane] = stack[0].reward;
  if (success != nullptr) success[lane] = stack[0].success;
  if (valid != nullptr) valid[lane] = stack[0].valid;
}

}  // namespace

// The task of table `words` (int32[n_words], ops/task_eval.py's layout) on
// `batch` lanes of `k_max` sprite slots: factors f32[.., 10] (lane b's slot
// k at factors + b * fstride_b + k * fstride_k, columns contiguous),
// num_sprites i32 (lane b's at b * nstride). Writes reward f32[batch],
// success and valid u8[batch] (0 or 1), each only where its pointer is not
// null, on `stream`; returns the CUDA error code (0 on success).
extern "C" int task_eval_launch(const float* factors, long long fstride_b,
                                long long fstride_k, const int* num_sprites,
                                long long nstride, const int* words,
                                int n_words, int batch, int k_max,
                                float* reward, unsigned char* success,
                                unsigned char* valid, void* stream) {
  if (batch <= 0) return 0;
  if (n_words < kHeader || n_words > kMaxWords || k_max < 0 ||
      k_max > kMaxSlots ||
      (reward == nullptr && success == nullptr && valid == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      (static_cast<long long>(batch) + kWarps - 1) / kWarps;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  task_eval_kernel<<<static_cast<unsigned>(blocks), kThreads,
                     n_words * sizeof(int),
                     static_cast<cudaStream_t>(stream)>>>(
      factors, fstride_b, fstride_k, num_sprites, nstride, words, n_words,
      batch, k_max, reward, success, valid);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
