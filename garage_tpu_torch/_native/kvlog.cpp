// Native metadata KV engine: the C++ core of db_engine = "native".
//
// Same role as the reference's LMDB adapter (src/db/lmdb_adapter.rs): the
// fast durable engine behind the generic Db/Tree/Tx abstraction.  Design
// is the repo's log-structured engine (db/log_engine.py) re-done native:
//
//   - full keyspace in RAM as ordered maps (std::map per tree): O(log n)
//     point ops and ordered range scans at native speed — fixing the
//     Python engine's O(n) sorted-list inserts, which degrade badly past
//     ~100k keys;
//   - every commit appends ONE crc-framed batch to the write-ahead log;
//     recovery replays frames until the first bad/short one and truncates
//     the torn tail (atomicity = frame integrity);
//   - compaction rewrites live state to <path>.new, fsyncs, renames.
//
// The on-disk format is BYTE-IDENTICAL to db/log_engine.py (frame =
// [u32 len][u32 crc32][payload]; record = [u8 op][u16 tlen][tree]
// [u32 klen][k]([u32 vlen][v] if put)), so a store written by either
// engine opens in the other — convert-db not required to switch.
//
// Sync modes (kv_open's second arg):
//   0 = none   : no per-commit sync (compact/close still fsync)
//   1 = full   : fdatasync inside every kv_commit (strict durability)
//   2 = group  : classic group commit — kv_commit appends + applies and
//                returns immediately; a dedicated flusher thread runs
//                fdatasync continuously while commits are pending, so
//                every commit becomes durable within ~one fdatasync
//                (fsync absorption: all frames appended while a sync is
//                in flight are covered by the next one).  This matches
//                sqlite WAL + synchronous=NORMAL and the reference's
//                default metadata_fsync=false LMDB posture, at a
//                bounded (~200 us) window.  kv_sync_barrier() waits for
//                full durability (used by snapshot/close).
//
// Thread-safety contract: a handle's MAPS serve exactly one caller
// thread at a time (the daemon's asyncio loop under the GIL) — reads and
// iteration take no locks.  db->mu protects only what the internal
// flusher thread shares with callers: the fd, the byte/seq counters, and
// fd swaps during compaction.  The flusher itself never touches the maps.

#include <algorithm>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kCompactRatio = 3;
constexpr uint64_t kCompactMinBytes = 4ull * 1024 * 1024;
constexpr uint8_t kOpPut = 1;
constexpr uint8_t kOpDel = 2;

// zlib-compatible crc32 (poly 0xEDB88320), table built on first use.
uint32_t crc32_of(const uint8_t* data, size_t len) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int b = 0; b < 8; b++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

inline uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86/arm64), same as struct '<I'
}

inline void put_u32(std::string& out, uint32_t v) {
  out.append(reinterpret_cast<const char*>(&v), 4);
}

using TreeMap = std::map<std::string, std::string>;

struct KvDb {
  std::string path;
  int sync_mode = 1;  // 0 none, 1 full, 2 group
  int fd = -1;
  uint64_t log_bytes = 0;
  uint64_t live_bytes = 0;
  std::map<std::string, TreeMap> trees;

  // group-commit machinery (sync_mode == 2 only)
  std::mutex mu;
  std::condition_variable cv;
  std::thread flusher;
  uint64_t seq_committed = 0;  // frames appended
  uint64_t seq_durable = 0;    // frames covered by an fdatasync
  bool stop_flusher = false;
  // errno of the last failed flusher sync (0 = healthy).  While nonzero,
  // seq_durable is frozen and kv_sync_barrier fails fast instead of
  // waiting on durability that is not being achieved.
  int sync_err = 0;
  uint64_t sync_failures = 0;  // cumulative failed flusher sync attempts

  ~KvDb() {
    if (fd >= 0) ::close(fd);
  }
};

bool write_all(int fd, const void* buf, size_t len) {
  const char* p = static_cast<const char*>(buf);
  while (len > 0) {
    ssize_t n = ::write(fd, p, len);
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

// Structural check of one frame payload WITHOUT mutating state.  Commit
// validates before writing/applying so a malformed batch can never leave
// memory and disk divergent (a partial apply would make this process see
// keys the post-restart replay silently drops).
bool validate_payload(const uint8_t* p, size_t len) {
  size_t pos = 0;
  while (pos < len) {
    if (pos + 3 > len) return false;
    uint8_t op = p[pos];
    uint16_t tlen;
    std::memcpy(&tlen, p + pos + 1, 2);
    pos += 3 + tlen;
    if (pos + 4 > len) return false;
    uint32_t klen = rd_u32(p + pos);
    pos += 4 + klen;
    if (pos > len) return false;
    if (op == kOpPut) {
      if (pos + 4 > len) return false;
      uint32_t vlen = rd_u32(p + pos);
      pos += 4 + vlen;
      if (pos > len) return false;
    } else if (op != kOpDel) {
      return false;
    }
  }
  return true;
}

// Apply one frame payload to the in-memory state.  Returns false on a
// malformed record (treated like a corrupt frame by the replay caller).
bool apply_payload(KvDb* db, const uint8_t* p, size_t len) {
  size_t pos = 0;
  while (pos < len) {
    if (pos + 3 > len) return false;
    uint8_t op = p[pos];
    uint16_t tlen;
    std::memcpy(&tlen, p + pos + 1, 2);
    pos += 3;
    if (pos + tlen + 4 > len) return false;
    std::string tree(reinterpret_cast<const char*>(p + pos), tlen);
    pos += tlen;
    uint32_t klen = rd_u32(p + pos);
    pos += 4;
    if (pos + klen > len) return false;
    std::string key(reinterpret_cast<const char*>(p + pos), klen);
    pos += klen;
    TreeMap& t = db->trees[tree];
    auto it = t.find(key);
    if (op == kOpPut) {
      if (pos + 4 > len) return false;
      uint32_t vlen = rd_u32(p + pos);
      pos += 4;
      if (pos + vlen > len) return false;
      if (it != t.end())
        db->live_bytes -= key.size() + it->second.size();
      t[std::move(key)] =
          std::string(reinterpret_cast<const char*>(p + pos), vlen);
      db->live_bytes += klen + vlen;
      pos += vlen;
    } else if (op == kOpDel) {
      if (it != t.end()) {
        db->live_bytes -= key.size() + it->second.size();
        t.erase(it);
      }
    } else {
      return false;
    }
  }
  return true;
}

void enc_record(std::string& out, uint8_t op, const std::string& tree,
                const std::string& k, const std::string* v) {
  out.push_back(static_cast<char>(op));
  uint16_t tlen = static_cast<uint16_t>(tree.size());
  out.append(reinterpret_cast<const char*>(&tlen), 2);
  out.append(tree);
  put_u32(out, static_cast<uint32_t>(k.size()));
  out.append(k);
  if (op == kOpPut) {
    put_u32(out, static_cast<uint32_t>(v->size()));
    out.append(*v);
  }
}

// Replay the log; truncate a torn/corrupt tail in place.
bool replay(KvDb* db) {
  FILE* f = std::fopen(db->path.c_str(), "rb");
  if (f == nullptr) return errno == ENOENT;  // no log yet: fine
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(static_cast<size_t>(fsize));
  if (fsize > 0 && std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    std::fclose(f);
    return false;
  }
  std::fclose(f);
  size_t pos = 0, valid_end = 0;
  while (pos + 8 <= buf.size()) {
    uint32_t plen = rd_u32(buf.data() + pos);
    uint32_t crc = rd_u32(buf.data() + pos + 4);
    if (pos + 8 + plen > buf.size()) break;  // torn tail
    const uint8_t* payload = buf.data() + pos + 8;
    if (crc32_of(payload, plen) != crc) break;  // corrupt: stop here
    if (!apply_payload(db, payload, plen)) break;
    pos += 8 + plen;
    valid_end = pos;
  }
  if (valid_end < buf.size()) {
    if (::truncate(db->path.c_str(), static_cast<off_t>(valid_end)) != 0)
      return false;
  }
  db->log_bytes = valid_end;
  return true;
}

int compact(KvDb* db) {
  std::string tmp = db->path + ".new";
  int tfd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (tfd < 0) return -1;
  uint64_t total = 0;
  std::string payload, frame;
  for (const auto& [name, t] : db->trees) {
    if (t.empty()) continue;
    payload.clear();
    for (const auto& [k, v] : t) enc_record(payload, kOpPut, name, k, &v);
    frame.clear();
    put_u32(frame, static_cast<uint32_t>(payload.size()));
    put_u32(frame, crc32_of(reinterpret_cast<const uint8_t*>(payload.data()),
                            payload.size()));
    frame += payload;
    if (!write_all(tfd, frame.data(), frame.size())) {
      ::close(tfd);
      ::unlink(tmp.c_str());
      return -1;
    }
    total += frame.size();
  }
  int frc = ::fsync(tfd);
  int crc = ::close(tfd);  // close unconditionally: no fd leak on fsync fail
  if (frc != 0 || crc != 0) {
    ::unlink(tmp.c_str());
    return -1;
  }
  // Open the append fd to the NEW inode BEFORE the rename: the fd stays
  // valid across rename (same inode), so there is no window where db->fd
  // is closed/-1 and a failure can strand the handle.  Every early return
  // below leaves db->fd and the old log fully intact (true best-effort).
  int nfd = ::open(tmp.c_str(), O_WRONLY | O_APPEND, 0644);
  if (nfd < 0) {
    ::unlink(tmp.c_str());
    return -1;
  }
  if (::rename(tmp.c_str(), db->path.c_str()) != 0) {
    ::close(nfd);
    ::unlink(tmp.c_str());
    return -1;
  }
  {
    // fd swap + counters under mu: the flusher dups db->fd under this
    // lock.  Everything written so far is durable in the new inode
    // (fsynced before rename), so the durable seq catches up.
    std::lock_guard<std::mutex> lk(db->mu);
    if (db->fd >= 0) ::close(db->fd);
    db->fd = nfd;
    db->log_bytes = total;
    db->seq_durable = db->seq_committed;
  }
  db->cv.notify_all();
  // best-effort: persist the rename itself (directory entry)
  std::string dir = db->path.substr(0, db->path.find_last_of('/'));
  if (dir.empty()) dir = ".";
  int dfd = ::open(dir.c_str(), O_RDONLY);
  if (dfd >= 0) {
    ::fsync(dfd);
    ::close(dfd);
  }
  return 0;
}

void maybe_compact(KvDb* db) {
  uint64_t live = db->live_bytes > 0 ? db->live_bytes : 1;
  if (db->log_bytes > kCompactMinBytes && db->log_bytes > kCompactRatio * live)
    compact(db);  // best-effort: a failed compaction keeps the long log
}

// Group-commit flusher: fdatasync continuously while commits are pending.
// Syncs on a dup of the current fd OUTSIDE the lock, so appenders are
// never blocked by a sync in flight (absorption: frames appended during
// a sync are covered by the next loop turn).
void flusher_main(KvDb* db) {
  std::unique_lock<std::mutex> lk(db->mu);
  for (;;) {
    db->cv.wait(lk, [db] {
      return db->stop_flusher || db->seq_committed > db->seq_durable;
    });
    if (db->seq_committed <= db->seq_durable) {
      if (db->stop_flusher) return;
      continue;
    }
    uint64_t target = db->seq_committed;
    int sfd = ::dup(db->fd);
    int err = sfd < 0 ? errno : 0;
    lk.unlock();
    int rc = -1;
    if (sfd >= 0) {
      rc = ::fdatasync(sfd);
      if (rc != 0) err = errno;  // capture before close() can clobber it
      ::close(sfd);
    }
    lk.lock();
    if (rc == 0) {
      db->sync_err = 0;
      // a concurrent compact may have advanced seq_durable past target
      if (target > db->seq_durable) db->seq_durable = target;
      db->cv.notify_all();
    } else {
      // dup or fdatasync failed: seq_durable must NOT advance — doing so
      // would make kv_sync_barrier() report unsynced commits as durable.
      // Surface the error (barrier waiters fail fast on sync_err) and
      // pace the retry with a bounded wait instead of busy-spinning on
      // the still-true wait predicate; a later successful sync (e.g.
      // after a compaction swapped in a fresh fd) clears the state.
      db->sync_err = err ? err : EIO;
      db->sync_failures++;
      db->cv.notify_all();
      db->cv.wait_for(lk, std::chrono::milliseconds(50),
                      [db] { return db->stop_flusher; });
      if (db->stop_flusher) return;
    }
  }
}

}  // namespace

extern "C" {

void* kv_open(const char* path, int sync_mode) {
  KvDb* db = new KvDb();
  db->path = path;
  db->sync_mode = sync_mode;
  if (!replay(db)) {
    delete db;
    return nullptr;
  }
  db->fd = ::open(path, O_WRONLY | O_APPEND | O_CREAT, 0644);
  if (db->fd < 0) {
    delete db;
    return nullptr;
  }
  if (db->sync_mode == 2) db->flusher = std::thread(flusher_main, db);
  return db;
}

int kv_close(void* h) {
  KvDb* db = static_cast<KvDb*>(h);
  if (db->flusher.joinable()) {
    {
      std::lock_guard<std::mutex> lk(db->mu);
      db->stop_flusher = true;
    }
    db->cv.notify_all();
    db->flusher.join();
  }
  int rc = compact(db);  // rewrites + fsyncs live state
  delete db;
  return rc;
}

// Durability barrier: returns once every commit acknowledged so far is
// on stable storage (group mode waits for the flusher; other modes
// fdatasync inline).  Used by snapshot and by operators wanting an
// explicit sync point.
int kv_sync_barrier(void* h) {
  KvDb* db = static_cast<KvDb*>(h);
  std::unique_lock<std::mutex> lk(db->mu);
  if (db->sync_mode == 2 && db->flusher.joinable()) {
    uint64_t target = db->seq_committed;
    db->cv.notify_all();
    // a failing flusher (sync_err set) must surface here, not hang the
    // barrier forever on durability the disk is refusing to provide
    db->cv.wait(lk, [&] {
      return db->seq_durable >= target || db->sync_err != 0;
    });
    return db->seq_durable >= target ? 0 : -1;
  }
  return ::fdatasync(db->fd) == 0 ? 0 : -1;
}

// Flusher health introspection: cumulative failed sync attempts (for
// metrics/tests; 0 on a healthy handle, or for non-group sync modes).
uint64_t kv_sync_failures(void* h) {
  KvDb* db = static_cast<KvDb*>(h);
  std::lock_guard<std::mutex> lk(db->mu);
  return db->sync_failures;
}

// Commit one batch: payload is the concatenated record encoding (exactly
// what goes inside the frame).  Appends the frame, fsyncs if configured,
// applies to memory, maybe compacts.
int kv_commit(void* h, const uint8_t* payload, size_t len) {
  KvDb* db = static_cast<KvDb*>(h);
  // Validate BEFORE writing or applying: a malformed batch is rejected
  // with no disk write and no memory mutation, so the -2 path can never
  // leave an acked-in-memory key that a post-restart replay would drop.
  if (!validate_payload(payload, len)) return -2;
  std::string frame;
  frame.reserve(len + 8);
  put_u32(frame, static_cast<uint32_t>(len));
  put_u32(frame, crc32_of(payload, len));
  frame.append(reinterpret_cast<const char*>(payload), len);
  {
    std::lock_guard<std::mutex> lk(db->mu);  // fd/counters vs flusher
    if (!write_all(db->fd, frame.data(), frame.size()) ||
        (db->sync_mode == 1 && ::fdatasync(db->fd) != 0)) {
      // A partial frame left in the log would make the NEXT replay stop
      // at its bad crc and discard every later acknowledged commit.
      // Roll the failed commit off the file so later appends start at a
      // clean frame boundary (best-effort: if even truncate fails the fd
      // is hosed and every later commit errors too).
      ::ftruncate(db->fd, static_cast<off_t>(db->log_bytes));
      return -1;
    }
  }
  if (!apply_payload(db, payload, len)) {
    // Unreachable after the validate above (apply's structural checks
    // are a subset) — kept as a belt-and-braces guard: roll the (not yet
    // counted) frame off the file so replay never stops at it.
    std::lock_guard<std::mutex> lk(db->mu);
    ::ftruncate(db->fd, static_cast<off_t>(db->log_bytes));
    return -2;
  }
  {
    std::lock_guard<std::mutex> lk(db->mu);
    db->log_bytes += frame.size();
    db->seq_committed++;
  }
  if (db->sync_mode == 2) db->cv.notify_all();
  maybe_compact(db);
  return 0;
}

// Point read.  *out points into internal storage — valid until the next
// mutation of this key; the (GIL-holding) caller copies immediately.
int kv_get(void* h, const char* tree, size_t tlen, const uint8_t* k,
           size_t klen, const uint8_t** out, size_t* outlen) {
  KvDb* db = static_cast<KvDb*>(h);
  auto ti = db->trees.find(std::string(tree, tlen));
  if (ti == db->trees.end()) return 0;
  auto it = ti->second.find(std::string(reinterpret_cast<const char*>(k), klen));
  if (it == ti->second.end()) return 0;
  *out = reinterpret_cast<const uint8_t*>(it->second.data());
  *outlen = it->second.size();
  return 1;
}

uint64_t kv_tree_len(void* h, const char* tree, size_t tlen) {
  KvDb* db = static_cast<KvDb*>(h);
  auto ti = db->trees.find(std::string(tree, tlen));
  return ti == db->trees.end() ? 0 : ti->second.size();
}

// Packed tree-name list: [u16 len][name]... — returns bytes needed; only
// writes when cap suffices (caller retries with a larger buffer).
size_t kv_tree_names(void* h, uint8_t* buf, size_t cap) {
  KvDb* db = static_cast<KvDb*>(h);
  size_t need = 0;
  for (const auto& [name, t] : db->trees) need += 2 + name.size();
  if (need > cap) return need;
  size_t pos = 0;
  for (const auto& [name, t] : db->trees) {
    uint16_t n = static_cast<uint16_t>(name.size());
    std::memcpy(buf + pos, &n, 2);
    std::memcpy(buf + pos + 2, name.data(), name.size());
    pos += 2 + name.size();
  }
  return need;
}

// Ordered range scan, one chunk per call.  Writes up to max_items (0 =
// no limit) packed [u32 klen][k][u32 vlen][v] entries of the range
// [start, end) — descending from end when reverse — into buf, stopping
// before an entry that would overflow cap.  Returns bytes written;
// *done = 1 when the range is exhausted.  The caller resumes with
// start = last_key + '\0' (forward) or end = last_key (reverse); a chunk
// of 0 bytes with *done == 0 means one entry exceeds cap — grow and retry.
size_t kv_iter_chunk(void* h, const char* tree, size_t tlen,
                     const uint8_t* start, size_t slen, int has_start,
                     const uint8_t* end, size_t elen, int has_end, int reverse,
                     uint32_t max_items, uint8_t* buf, size_t cap, int* done) {
  KvDb* db = static_cast<KvDb*>(h);
  *done = 1;
  auto ti = db->trees.find(std::string(tree, tlen));
  if (ti == db->trees.end()) return 0;
  TreeMap& t = ti->second;
  std::string skey(reinterpret_cast<const char*>(start), has_start ? slen : 0);
  std::string ekey(reinterpret_cast<const char*>(end), has_end ? elen : 0);
  auto lo = has_start ? t.lower_bound(skey) : t.begin();
  auto hi = has_end ? t.lower_bound(ekey) : t.end();
  size_t pos = 0;
  uint32_t items = 0;
  auto emit = [&](const std::string& k, const std::string& v) -> bool {
    size_t need = 8 + k.size() + v.size();
    if (pos + need > cap) {
      *done = 0;
      return false;
    }
    uint32_t n = static_cast<uint32_t>(k.size());
    std::memcpy(buf + pos, &n, 4);
    std::memcpy(buf + pos + 4, k.data(), k.size());
    n = static_cast<uint32_t>(v.size());
    std::memcpy(buf + pos + 4 + k.size(), &n, 4);
    std::memcpy(buf + pos + 8 + k.size(), v.data(), v.size());
    pos += need;
    items++;
    if (max_items != 0 && items >= max_items) {
      *done = 0;
      return false;
    }
    return true;
  };
  if (!reverse) {
    for (auto it = lo; it != hi; ++it)
      if (!emit(it->first, it->second)) {
        return pos;
      }
  } else {
    auto it = hi;
    while (it != lo) {
      --it;
      if (!emit(it->first, it->second)) return pos;
    }
  }
  return pos;
}

int kv_compact_now(void* h) { return compact(static_cast<KvDb*>(h)); }

uint64_t kv_log_bytes(void* h) { return static_cast<KvDb*>(h)->log_bytes; }
uint64_t kv_live_bytes(void* h) { return static_cast<KvDb*>(h)->live_bytes; }

}  // extern "C"
