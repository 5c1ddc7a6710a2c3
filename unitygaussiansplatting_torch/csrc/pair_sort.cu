// The pair sort: a stable LSD radix sort of K2's (tile | depth) keys.
//
// Replaces no TPU kernel: the TPU package leaves its two-key sort to XLA
// (jax.lax.sort, unitygaussiansplatting_tpu/ops/pair_expand.py:698), and the
// port had left it to torch.sort, which runs a library radix sort over all
// 64 bits of K2's int64 key ((tile << db | depth) << 31 | splat) and its
// int64 indices: 8 passes, each moving 32 bytes a slot.  Two facts make
// that 4x the work the order needs:
//   - the low 31 bits, the splat id, need no sorting: slots are
//     splat-major (splat i owns [bounds[i], bounds[i+1]), tail slots carry
//     id N), so the id never falls as the slot rises, and a *stable* sort on
//     comp >> 31 with the slot as its value gives torch.sort's permutation;
//   - comp >> 31 is tb + db <= 32 bits (ops/binning.py:depth_key_bits), so
//     ceil((tb + db) / 8) passes of 8-bit digits, 4 at every grid the port
//     renders, each moving a 4-byte key and a 4-byte slot.
//
// Two routes, chosen by whether the caller wants the permutation:
//   - the per-slot route (autograd, center packing: the backward reads perm
//     over every slot) sorts all K slots, each key with its slot as value;
//     its last pass writes perm, pair_tile and pair_rank over [0, K);
//   - the record route (a frame without autograd: the composite reads each
//     pair's record through its splat id, and nothing per slot moves) sorts
//     only the R keys whose tile is real.  The others sit in the sentinel
//     tile num_tiles: the unused tail past the demand bounds[N], a slot a
//     dead splat, K2's ellipse culls; the composite never reads them, and
//     they all sort after every real key, their tile being the largest, so
//     dropping them leaves the real keys' order as it was.  The upsweep
//     reads the slots up to the demand, counts only keys below
//     num_tiles << db and adds their number R to a word of the state; pass 0
//     drops the sentinel tile's keys and writes a dense array of R keys,
//     each valued with its splat id (stability rests on the input order, not
//     on the value), which the last pass writes to pair_rank as it is; each
//     later pass covers R keys; the last writes pair_tile and pair_rank over
//     [0, R) only, and the search gives tile_starts[num_tiles] = R.  R is
//     read on the card: a pass keeps the budget's grid, and a block whose
//     tile starts at or past its input's end exits before it publishes
//     anything (look-back only walks earlier tiles, all live).
//
// Bound on the H100 by bytes.  At K slots the per-slot route reads K2's
// int64 keys twice (the upsweep and the first pass) and moves 8 bytes a slot
// in and out of each pass; the last pass writes the int64 permutation, the
// tile of each sorted pair (key >> db) and its splat id (a gather by slot):
// ~90 bytes a slot instead of the library's ~256.  The record route reads
// the keys up to the demand twice, and moves 8 bytes a real pair in and out
// of each pass: at the bicycle case (K 15.25M, R 10.04M) the later passes
// cover two thirds of the slots, and pass 0 writes 8 bytes a real pair
// instead of 12 a slot.  Each pass moves its bytes at about the rate of the
// library's own passes (~2.1 TB/s on the H100), so the gain is the bytes.
// The design (Onesweep, Adinets and Merrill 2022, arXiv 2206.01784) reads
// and writes each key once a pass:
//   - one upsweep kernel reads the keys once and builds every pass's digit
//     histogram in shared memory (on the per-slot route a warp whose keys
//     are all equal, as the unused tail slots are, adds once), one global
//     atomic a bin a block; it also clears the first pass's look-back state;
//   - one kernel a pass: a block takes the next tile of kTileKeys keys from
//     an atomic counter (so every tile it looks back on is already running
//     and look-back cannot deadlock), ranks its keys with warp-level match
//     masks into per-warp digit counts (a key the pass does not move, past
//     the input or in the sentinel tile on the record route, ranks in a
//     class of its own, is counted nowhere and never written), publishes its
//     counts, orders the tile by digit in shared memory and finds each
//     digit's global offset by decoupled look-back over the earlier tiles;
//     then each thread writes runs of one digit to consecutive addresses;
//   - the first pass makes each key from K2's int64 (comp >> 31) and its
//     value from its position (per-slot) or its splat id (record), so no
//     value array is read; on the per-slot route it writes each slot's
//     splat id (comp's low 31 bits) to a 4-byte array, which the last pass
//     gathers by slot for pair_rank: half the bytes of a gather from the
//     int64 keys, and an array the card's 50 MB L2 holds most of; each pass
//     clears the look-back state the next pass uses (two buffers in turn);
//   - a last small kernel finds tile_starts by binary search over the
//     sorted tiles.
// The kernels allocate nothing: the wrapper (ops/pair_expand.py:
// sort_keys_cuda) gives them the key and value double buffers, the splat
// ids (per-slot route), the histograms, tile counters and R (cleared by one
// memset), the look-back state and the outputs.

#include <cuda_runtime.h>

namespace {

constexpr int kRadix = 256;  // 8-bit digits
constexpr int kMaxPasses = 4;
// A pass's block: one thread a digit in the prefix steps, 15 keys a thread,
// 4 blocks an SM (64 registers a thread, 41 KB of shared memory a block).
// Measured on the H100 at 15.25M keys: 12 or 16 keys a thread, 3 or 5
// blocks an SM, or more look-back loads in flight are no faster.
constexpr int kThreads = 256;
constexpr int kItems = 15;
constexpr int kMinBlocks = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpKeys = 32 * kItems;
constexpr int kTileKeys = kThreads * kItems;
static_assert(kThreads == kRadix, "a pass's prefix steps take one thread a digit");

// The upsweep: a warp loads kUpItems keys a lane at a time and counts them
// into one of kUpParts copies of the histograms (fewer warps contend for a
// bin).
constexpr int kUpThreads = 256;
constexpr int kUpWarps = kUpThreads / 32;
constexpr int kUpItems = 8;
constexpr int kUpWarpKeys = 32 * kUpItems;
constexpr int kUpParts = 4;
constexpr int kUpBlocksPerSm = 4;

// A look-back word: flag << 32 | count.  0: not yet published; aggregate:
// this tile's count of the digit; inclusive: that count plus every earlier
// tile's.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
// The key of a position past the input: never below the sentinel tile's
// first key, so the record route never moves it.
constexpr unsigned kPastEnd = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned key_of(long long comp) { return (unsigned)((unsigned long long)comp >> 31); }
__device__ __forceinline__ unsigned splat_of(long long comp) { return (unsigned)comp & 0x7FFFFFFFu; }

// The slots the record route reads: those below the demand (null: all k),
// within the budget.
__device__ __forceinline__ long long demand_slots(const int* demand, int k) {
  if (demand == nullptr) return k;
  const long long d = *demand;
  return d < 0 ? 0 : d < k ? d : k;
}

__device__ __forceinline__ void publish(unsigned long long* word, unsigned long long value) {
  *(volatile unsigned long long*)word = value;
}

// The count of digit d in every tile before `tile`: the earlier tiles'
// words summed from the nearest back until an inclusive one, each read
// until it is published.
__device__ __forceinline__ unsigned look_back(const unsigned long long* lookback, int tile, int d) {
  unsigned prefix = 0;
  for (int j = tile - 1;; --j) {
    unsigned long long w;
    do {
      w = *(const volatile unsigned long long*)(lookback + (long long)j * kRadix + d);
    } while ((w >> 32) == 0);
    prefix += (unsigned)w;
    if ((w >> 32) == (kInclusive >> 32)) return prefix;
  }
}

// kReal: the record route (keys up to the demand, only those below `top` =
// num_tiles << db counted, their number added to *real).
template <bool kReal>
__global__ void __launch_bounds__(kUpThreads) upsweep_kernel(const long long* __restrict__ comp, int k,
                                                             const int* __restrict__ demand, unsigned top,
                                                             int passes, unsigned* __restrict__ hist,
                                                             unsigned* __restrict__ real,
                                                             unsigned long long* __restrict__ lookback,
                                                             long long lookback_words) {
  __shared__ unsigned s_hist[kUpParts][kMaxPasses * kRadix];
  __shared__ unsigned s_real;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = t; i < kUpParts * kMaxPasses * kRadix; i += kUpThreads) (&s_hist[0][0])[i] = 0;
  if (t == 0) s_real = 0;
  const long long threads = (long long)gridDim.x * kUpThreads;
  for (long long i = (long long)blockIdx.x * kUpThreads + t; i < lookback_words; i += threads) lookback[i] = 0ull;
  __syncthreads();
  const long long n = kReal ? demand_slots(demand, k) : k;
  unsigned* const h = s_hist[warp % kUpParts];
  unsigned mine = 0;  // the record route: this thread's real keys
  const long long warps = (long long)gridDim.x * kUpWarps;
  for (long long first = ((long long)blockIdx.x * kUpWarps + warp) * kUpWarpKeys; first < n;
       first += warps * kUpWarpKeys) {
    unsigned key[kUpItems];
#pragma unroll
    for (int i = 0; i < kUpItems; ++i) {
      const long long pos = first + i * 32 + lane;
      key[i] = pos < n ? key_of(__ldg(comp + pos)) : kPastEnd;
    }
#pragma unroll
    for (int i = 0; i < kUpItems; ++i) {
      if (kReal) {
        if (key[i] < top) {
          ++mine;
          for (int p = 0; p < passes; ++p) atomicAdd(&h[p * kRadix + ((key[i] >> (8 * p)) & (kRadix - 1))], 1u);
        }
        continue;
      }
      const bool in = first + i * 32 + lane < n;
      // The unused tail slots share one key: a warp of equal keys adds once.
      const unsigned key0 = __shfl_sync(0xFFFFFFFFu, key[i], 0);
      if (__all_sync(0xFFFFFFFFu, in && key[i] == key0)) {
        if (lane == 0)
          for (int p = 0; p < passes; ++p) atomicAdd(&h[p * kRadix + ((key0 >> (8 * p)) & (kRadix - 1))], 32u);
      } else if (in) {
        for (int p = 0; p < passes; ++p) atomicAdd(&h[p * kRadix + ((key[i] >> (8 * p)) & (kRadix - 1))], 1u);
      }
    }
  }
  if (kReal && mine) atomicAdd(&s_real, mine);
  __syncthreads();
  for (int i = t; i < passes * kRadix; i += kUpThreads) {
    unsigned c = 0;
#pragma unroll
    for (int q = 0; q < kUpParts; ++q) c += s_hist[q][i];
    if (c) atomicAdd(hist + i, c);
  }
  if (kReal && t == 0 && s_real) atomicAdd(real, s_real);
}

// One pass over digit (key >> shift) & 255.  kFirst: keys from K2's int64
// comp, values their positions (per-slot route; each slot's splat id
// written to splats) or their splat ids (record route).  kLast: writes
// perm (per-slot route: int64 slot), pair_tile (key >> db) and pair_rank
// (the splat id) instead of the next pass's keys and values.  kReal: the
// record route, over the keys below the demand in pass 0, keeping those
// below `top`, and over the R = *real keys they leave in every later pass.
template <bool kFirst, bool kLast, bool kReal>
__global__ void __launch_bounds__(kThreads, kMinBlocks) pass_kernel(
    const long long* __restrict__ comp, const unsigned* __restrict__ keys_in, const unsigned* __restrict__ vals_in,
    unsigned* __restrict__ keys_out, unsigned* __restrict__ vals_out, unsigned* __restrict__ splats,
    long long* __restrict__ perm, int* __restrict__ pair_tile, int* __restrict__ pair_rank, int k,
    const int* __restrict__ demand, const unsigned* __restrict__ real, unsigned top, int shift, int db,
    const unsigned* __restrict__ hist, unsigned* __restrict__ counter, unsigned long long* lookback,
    unsigned long long* __restrict__ lookback_next) {
  __shared__ unsigned s_warp_hist[kWarps][kRadix];  // counts, then each warp's offset within a digit
  __shared__ unsigned s_keys[kTileKeys];
  __shared__ unsigned s_vals[kTileKeys];
  __shared__ unsigned s_local_start[kRadix];
  __shared__ int s_base[kRadix];  // global position of a tile position of the digit, less that position
  __shared__ unsigned long long s_scan[kWarps];
  __shared__ long long s_n;
  __shared__ int s_tile, s_moved;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    s_tile = (int)atomicAdd(counter, 1u);
    s_n = !kReal ? (long long)k : kFirst ? demand_slots(demand, k) : (long long)*real;
  }
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_warp_hist[w][t] = 0;
  __syncthreads();
  const int tile = s_tile;
  const long long n = s_n;  // the keys this pass reads
  const long long tile_first = (long long)tile * kTileKeys;
  // The record route's grid is the budget's: a tile past the input exits
  // before it publishes.  Every later tile exits too, so no tile looks back
  // on it, and the next pass reads fewer keys, so it needs no look-back
  // state cleared here.
  if (kReal && tile_first >= n) return;
  if (lookback_next != nullptr) lookback_next[(long long)tile * kRadix + t] = 0ull;

  // Warp-striped: item i of a lane is tile position warp * kWarpKeys + i * 32 + lane.
  unsigned key[kItems];
  const long long warp_first = tile_first + warp * kWarpKeys + lane;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long pos = warp_first + i * 32;
    if (pos < n) {
      if (kFirst) {
        const long long c = comp[pos];
        key[i] = key_of(c);
        if (!kReal && !kLast) splats[pos] = splat_of(c);
      } else {
        key[i] = keys_in[pos];
      }
    } else {
      key[i] = kPastEnd;
    }
  }
  // Whether the pass moves item i: on the record route a key below `top`
  // (past the input: kPastEnd), on the per-slot route any key of the input.
  auto moved = [&](int i) { return kReal ? key[i] < top : warp_first + i * 32 < n; };

  // Rank within the warp, in tile order: lanes with one digit find each
  // other by match mask; the lowest adds their number to the warp's count
  // and hands them the count before it.  Keys the pass does not move share
  // the class kRadix, counted nowhere.
  unsigned rank[kItems];
  unsigned* const my_hist = s_warp_hist[warp];
  const unsigned lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned d = moved(i) ? (key[i] >> shift) & (kRadix - 1) : kRadix;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const int leader = __ffs(peers) - 1;
    unsigned before = 0;
    if (lane == leader && d < kRadix) before = atomicAdd(&my_hist[d], (unsigned)__popc(peers));
    rank[i] = __shfl_sync(0xFFFFFFFFu, before, leader) + __popc(peers & lanes_below);
  }
  __syncthreads();

  // Thread d: the digit's offset in each warp, its count in the tile, published.
  const int d = t;
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = s_warp_hist[w][d];
    s_warp_hist[w][d] = count;
    count += c;
  }
  unsigned long long* const my_word = lookback + (long long)tile * kRadix + d;
  publish(my_word, (tile == 0 ? kInclusive : kAggregate) | count);

  // One exclusive scan over the digits of (all keys' count << 32 | this
  // tile's count): each digit's first global position and its first tile
  // position.
  const unsigned long long both = ((unsigned long long)hist[d] << 32) | count;
  unsigned long long incl = both;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long up = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  unsigned long long excl = incl - both;
  for (int w = 0; w < warp; ++w) excl += s_scan[w];
  const unsigned global_start = (unsigned)(excl >> 32);
  const unsigned local_start = (unsigned)excl;
  s_local_start[d] = local_start;
  if (d == kRadix - 1) s_moved = (int)(local_start + count);  // the keys of the tile this pass moves
  __syncthreads();

  // The moved keys of the tile in digit order, in shared memory.
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (!moved(i)) continue;
    const long long pos = warp_first + i * 32;
    const unsigned dd = (key[i] >> shift) & (kRadix - 1);
    const unsigned at = s_local_start[dd] + s_warp_hist[warp][dd] + rank[i];
    s_keys[at] = key[i];
    s_vals[at] = !kFirst ? vals_in[pos] : kReal ? splat_of(comp[pos]) : (unsigned)pos;
  }

  // Decoupled look-back: the digit's count in every earlier tile.
  const unsigned prefix = tile > 0 ? look_back(lookback, tile, d) : 0u;
  if (tile > 0) publish(my_word, kInclusive | (prefix + count));
  s_base[d] = (int)(global_start + prefix) - (int)local_start;
  __syncthreads();

  // Striped out of shared memory: neighbouring threads write neighbouring
  // positions of one digit.
  const int tile_moved = s_moved;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int at = i * kThreads + t;
    if (at < tile_moved) {
      const unsigned kk = s_keys[at], vv = s_vals[at];
      const int dest = s_base[(kk >> shift) & (kRadix - 1)] + at;
      if (kLast) {
        if (!kReal) perm[dest] = (long long)vv;
        pair_tile[dest] = (int)(kk >> db);
        pair_rank[dest] = kReal ? (int)vv : kFirst ? (int)splat_of(comp[vv]) : (int)splats[vv];
      } else {
        keys_out[dest] = kk;
        vals_out[dest] = vv;
      }
    }
  }
}

template <bool kReal, typename... Args>
void launch_pass(bool first, bool last, int tiles, cudaStream_t st, Args... args) {
  if (first && last) pass_kernel<true, true, kReal><<<tiles, kThreads, 0, st>>>(args...);
  else if (first) pass_kernel<true, false, kReal><<<tiles, kThreads, 0, st>>>(args...);
  else if (last) pass_kernel<false, true, kReal><<<tiles, kThreads, 0, st>>>(args...);
  else pass_kernel<false, false, kReal><<<tiles, kThreads, 0, st>>>(args...);
}

// tile_starts[t]: the first sorted pair whose tile is >= t, of the n sorted
// pairs (*sorted, or k where null).
__global__ void starts_kernel(const int* __restrict__ pair_tile, int k, const unsigned* __restrict__ sorted,
                              int num_tiles, int* __restrict__ tile_starts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t > num_tiles) return;
  int lo = 0, hi = sorted == nullptr ? k : (int)*sorted;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (pair_tile[mid] < t) lo = mid + 1;
    else hi = mid;
  }
  tile_starts[t] = lo;
}

}  // namespace

extern "C" {

const char* pair_sort_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

// Keys a pass's block sorts: the wrapper sizes the look-back state by it.
int pair_sort_tile_keys() { return kTileKeys; }

// state (passes * 257 + 1,) int32: the digit histograms of every pass (256
// each), a tile counter a pass, then R, the keys the record route sorts;
// cleared here, then counted from comp (k,) int64.  real_only: the record
// route (only the keys below num_tiles << db, of the slots below demand,
// a device int32, or all k where null); else every key of comp.  lookback
// (2, tiles, 256) int64 with tiles = ceil(k / pair_sort_tile_keys()): the
// first buffer is cleared for the first pass.  Launches on `stream`;
// returns the first CUDA error.
int pair_sort_upsweep_launch(const void* comp, int k, const void* demand, int real_only, int num_tiles, int db,
                             int passes, void* state, void* lookback, int tiles, void* stream) {
  if (passes < 1 || passes > kMaxPasses || k < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(state, 0, sizeof(unsigned) * (passes * (kRadix + 1) + 1), st);
  if (err != cudaSuccess || k == 0) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long chunks = ((long long)k + kUpThreads * kUpItems - 1) / (kUpThreads * kUpItems);
  const int blocks = (int)(chunks < (long long)sms * kUpBlocksPerSm ? chunks : (long long)sms * kUpBlocksPerSm);
  unsigned* const hist = (unsigned*)state;
  unsigned* const real = hist + passes * (kRadix + 1);
  const unsigned top = (unsigned)num_tiles << db;
  if (real_only)
    upsweep_kernel<true><<<blocks, kUpThreads, 0, st>>>((const long long*)comp, k, (const int*)demand, top, passes,
                                                         hist, real, (unsigned long long*)lookback,
                                                         (long long)tiles * kRadix);
  else
    upsweep_kernel<false><<<blocks, kUpThreads, 0, st>>>((const long long*)comp, k, nullptr, top, passes, hist,
                                                          real, (unsigned long long*)lookback,
                                                          (long long)tiles * kRadix);
  return (int)cudaGetLastError();
}

// Pass `pass` of `passes` over digit (key >> 8 * pass) & 255.  keys and
// vals (2, k) int32, the double buffers: pass p writes buffer p % 2 and
// reads buffer (p - 1) % 2 (the first pass reads comp).  perm (k,) int64
// wanted: the per-slot route, over all k slots (the first pass writes
// splats (k,) int32, each slot's splat id); the last pass writes perm,
// pair_tile (k,) int32 (key >> db) and pair_rank (k,) int32 (the splat id
// of the slot).  perm null: the record route, over the slots below demand
// (as for the upsweep) in the first pass and the R keys below num_tiles <<
// db they hold in every later pass; the last pass writes pair_tile and
// pair_rank over [0, R) only.  Launches on `stream` (nothing for k = 0);
// returns cudaGetLastError().
int pair_sort_pass_launch(const void* comp, void* keys, void* vals, void* splats, int k, const void* demand,
                          int num_tiles, int pass, int passes, int db, void* state, void* lookback, int tiles,
                          void* perm, void* pair_tile, void* pair_rank, void* stream) {
  if (passes < 1 || passes > kMaxPasses || pass < 0 || pass >= passes || k < 0) return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long words = (long long)tiles * kRadix;
  unsigned long long* const lb = (unsigned long long*)lookback;
  unsigned long long* const lb_this = lb + (pass % 2) * words;
  unsigned long long* const lb_next = pass + 1 < passes ? lb + ((pass + 1) % 2) * words : nullptr;
  const unsigned* const hist = (const unsigned*)state + pass * kRadix;
  unsigned* const counter = (unsigned*)state + passes * kRadix + pass;
  const unsigned* const real = (const unsigned*)state + passes * (kRadix + 1);
  const unsigned* const keys_in = (const unsigned*)keys + ((pass + 1) % 2) * (long long)k;
  const unsigned* const vals_in = (const unsigned*)vals + ((pass + 1) % 2) * (long long)k;
  unsigned* const keys_out = (unsigned*)keys + (pass % 2) * (long long)k;
  unsigned* const vals_out = (unsigned*)vals + (pass % 2) * (long long)k;
  const long long* const c = (const long long*)comp;
  const int* const dm = (const int*)demand;
  unsigned* const sp = (unsigned*)splats;
  long long* const p = (long long*)perm;
  int* const pt = (int*)pair_tile;
  int* const pr = (int*)pair_rank;
  const unsigned top = (unsigned)num_tiles << db;
  const int shift = 8 * pass;
  const bool first = pass == 0, last = pass + 1 == passes;
  if (p == nullptr)
    launch_pass<true>(first, last, tiles, st, c, keys_in, vals_in, keys_out, vals_out, sp, p, pt, pr, k, dm, real, top,
                      shift, db, hist, counter, lb_this, lb_next);
  else
    launch_pass<false>(first, last, tiles, st, c, keys_in, vals_in, keys_out, vals_out, sp, p, pt, pr, k, dm, real,
                       top, shift, db, hist, counter, lb_this, lb_next);
  return (int)cudaGetLastError();
}

// tile_starts (num_tiles + 1,) int32 from pair_tile (k,) int32, sorted
// over its first *sorted entries (the record route's R in the state's last
// word), or all k where sorted is null.  Launches on `stream`; returns
// cudaGetLastError().
int pair_sort_starts_launch(const void* pair_tile, int k, const void* sorted, int num_tiles, void* tile_starts,
                            void* stream) {
  const int threads = 256;
  const int blocks = (num_tiles + 1 + threads - 1) / threads;
  starts_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((const int*)pair_tile, k, (const unsigned*)sorted,
                                                              num_tiles, (int*)tile_starts);
  return (int)cudaGetLastError();
}

}  // extern "C"
