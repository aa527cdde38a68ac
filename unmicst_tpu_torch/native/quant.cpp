// Pillow's two quantizers, for unmicst_tpu_torch/io/quant.py: the median
// cut of Quant.c (Image.quantize's default for RGB, and convert("P",
// palette=ADAPTIVE)) and the fast octree of QuantOctree.c (the default for
// RGBA), with the hash table of QuantHash.c and the heap of QuantHeap.c
// whose orders decide their ties.  io/quant.py's median_cut_py and
// octree_py are the same algorithms in numpy and Python: the two give the
// same indices and palettes.
//
// Pixels come as n x 4 bytes (r, g, b, a; a is 255 for an RGB image), the
// indices go out as n bytes and the palette as 256 x 4 bytes.
//
// Build: with tiffcodec.cpp into one library by unmicst_tpu_torch/io/
//        _native.py (g++ -O3 -shared -fPIC, portable flags).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// -- QuantHash.c: chained buckets kept in ascending order of the compare
// function, grown or shrunk after each new key ----------------------------

constexpr uint32_t kMinLength = 11;
constexpr uint32_t kResizeFactor = 3;
constexpr uint32_t kMaxHashEntries = 65536;

// the prime search as Pillow runs it: its divisor test never fires, so it
// stops at the first number whose low four bits are 1, 3, 7, 9, 11 or 13
uint32_t find_prime(uint32_t start, int dir) {
  static const int unit[16] = {0, 1, 0, 1, 0, 0, 0, 1,
                               0, 1, 0, 1, 0, 1, 0, 0};
  while (start > 1) {
    if (!unit[start & 0x0f]) {
      start += dir;
      continue;
    }
    break;
  }
  return start;
}

inline uint32_t pixel_hash(uint32_t r, uint32_t g, uint32_t b) {
  return (r * 463u) ^ ((g << 8) * 10069u) ^ ((b << 16) * 64997u);
}

struct Node {
  int32_t next;
  uint32_t key;  // r | g << 8 | b << 16
  uint32_t value;
};

// keys compare by their hash at the table's scale (pixel_cmp); with
// scale < 0 by their bytes r, g, b (unshifted_pixel_cmp)
struct HashTable {
  std::vector<int32_t> table;
  std::vector<Node> nodes;
  uint32_t count = 0;
  int scale = 0;

  HashTable() : table(kMinLength, -1) {}

  uint32_t hash(uint32_t key) const {
    const uint32_t r = key & 255, g = (key >> 8) & 255, b = (key >> 16) & 255;
    if (scale < 0) return pixel_hash(r, g, b);
    return pixel_hash(r >> scale, g >> scale, b >> scale);
  }

  int cmp(uint32_t a, uint32_t b) const {
    if (scale < 0) {
      for (int s = 0; s < 24; s += 8) {
        const int d = (int)((a >> s) & 255) - (int)((b >> s) & 255);
        if (d) return d;
      }
      return 0;
    }
    const uint32_t A = hash(a), B = hash(b);
    return A == B ? 0 : (A < B ? -1 : 1);
  }

  // _hashtable_insert_node: a key already there takes the new key and
  // the value (collide: the sum); else the node goes in before the first
  // greater key
  void insert_node(int32_t idx, bool resize, bool collide) {
    Node& nd = nodes[idx];
    int32_t* link = &table[hash(nd.key) % table.size()];
    for (; *link >= 0; link = &nodes[*link].next) {
      Node& nv = nodes[*link];
      const int c = cmp(nv.key, nd.key);
      if (!c) {
        nv.key = nd.key;
        nv.value = collide ? nv.value + nd.value : nd.value;
        return;
      }
      if (c > 0) break;
    }
    nd.next = *link;
    *link = idx;
    count++;
    if (resize) this->resize();
  }

  void rehash(uint32_t new_size, bool collide) {
    std::vector<int32_t> old(new_size, -1);
    old.swap(table);
    count = 0;
    for (int32_t head : old) {
      for (int32_t n = head, nn; n >= 0; n = nn) {
        nn = nodes[n].next;
        insert_node(n, false, collide);
      }
    }
  }

  void resize() {
    const uint32_t old_size = table.size();
    uint32_t new_size = old_size;
    if (count * kResizeFactor < old_size) {
      new_size = find_prime(old_size / 2 - 1, -1);
    } else if (old_size * kResizeFactor < count) {
      new_size = find_prime(old_size * 2 + 1, +1);
    }
    if (new_size < kMinLength) new_size = old_size;
    if (new_size != old_size) rehash(new_size, false);
  }

  // hashtable_insert_or_update_computed with a count of 1, or one more
  void count_pixel(uint32_t key) {
    const uint32_t bucket = hash(key) % table.size();
    int32_t before = -1, n = table[bucket];
    for (; n >= 0; before = n, n = nodes[n].next) {
      const int c = cmp(nodes[n].key, key);
      if (!c) {
        nodes[n].value += 1;
        return;
      }
      if (c > 0) break;
    }
    nodes.push_back({n, key, 1});
    (before >= 0 ? nodes[before].next : table[bucket]) =
        (int32_t)nodes.size() - 1;
    count++;
    resize();
  }

  void insert(uint32_t key, uint32_t value) {
    nodes.push_back({-1, key, value});
    insert_node((int32_t)nodes.size() - 1, true, false);
  }

  bool lookup(uint32_t key, uint32_t* value) const {
    for (int32_t n = table[hash(key) % table.size()]; n >= 0;
         n = nodes[n].next) {
      const int c = cmp(nodes[n].key, key);
      if (!c) {
        *value = nodes[n].value;
        return true;
      }
      if (c > 0) break;
    }
    return false;
  }
};

// -- Quant.c's median cut ------------------------------------------------

struct PixelList {
  int32_t next[3], prev[3];
  uint8_t v[3];  // the scaled r, g, b
  int flag;
  uint32_t count;
};

struct BoxNode {
  int32_t l = -1, r = -1;
  int32_t head[3], tail[3];
  int volume = -1;
  uint32_t pixel_count = 0;
};

int32_t mergesort_pixels(std::vector<PixelList>& pl, int32_t head, int i) {
  if (head < 0 || pl[head].next[i] < 0) {
    if (head >= 0) pl[head].next[i] = pl[head].prev[i] = -1;
    return head;
  }
  int32_t c = head, t = head;
  for (; c >= 0 && t >= 0;
       c = pl[c].next[i],
       t = pl[t].next[i] >= 0 ? pl[pl[t].next[i]].next[i] : -1) {
  }
  if (c >= 0) {
    if (pl[c].prev[i] >= 0) pl[pl[c].prev[i]].next[i] = -1;
    pl[c].prev[i] = -1;
  }
  int32_t a = mergesort_pixels(pl, head, i);
  int32_t b = mergesort_pixels(pl, c, i);
  head = -1;
  int32_t p = -1;
  while (a >= 0 && b >= 0) {
    if (pl[a].v[i] > pl[b].v[i]) {
      c = a;
      a = pl[a].next[i];
    } else {
      c = b;
      b = pl[b].next[i];
    }
    pl[c].prev[i] = p;
    pl[c].next[i] = -1;
    if (p >= 0) pl[p].next[i] = c;
    p = c;
    if (head < 0) head = c;
  }
  if (a >= 0) {
    pl[c].next[i] = a;
    pl[a].prev[i] = c;
  } else if (b >= 0) {
    pl[c].next[i] = b;
    pl[b].prev[i] = c;
  }
  return head;
}

int box_volume(std::vector<PixelList>& pl, BoxNode& b) {
  if (b.volume >= 0) return b.volume;
  if (b.head[0] < 0) {
    b.volume = 0;
  } else {
    b.volume = (pl[b.head[0]].v[0] - pl[b.tail[0]].v[0] + 1) *
               (pl[b.head[1]].v[1] - pl[b.tail[1]].v[1] + 1) *
               (pl[b.head[2]].v[2] - pl[b.tail[2]].v[2] + 1);
  }
  return b.volume;
}

// splitlists: the first entries along the axis (the larger values) up to
// past half the pixels, and on while the value stays that of the last
// one, go left; the rest right (or, where that leaves none, the run of
// the tail's value)
void split(std::vector<PixelList>& pl, std::vector<BoxNode>& boxes,
           int32_t node) {
  BoxNode& nd = boxes[node];
  int f[3];
  for (int i = 0; i < 3; i++) {
    f[i] = pl[nd.head[i]].v[i] - pl[nd.tail[i]].v[i];
  }
  f[0] *= 77;
  f[1] *= 150;
  f[2] *= 29;
  int best = f[0], axis = 0;
  for (int i = 1; i < 3; i++) {
    if (best < f[i]) {
      best = f[i];
      axis = i;
    }
  }
  uint32_t n_count[2] = {0, 0};
  int n_right = 0;
  uint32_t left = 0;
  int32_t c = nd.head[axis];
  while (c >= 0) {
    left += pl[c].count;
    n_count[0] += pl[c].count;
    pl[c].flag = 0;
    c = pl[c].next[axis];
    if (left * 2 > nd.pixel_count) break;
  }
  if (c >= 0) {
    const int split_val = pl[pl[c].prev[axis]].v[axis];
    for (; c >= 0; c = pl[c].next[axis]) {
      if (split_val != pl[c].v[axis]) break;
      pl[c].flag = 0;
      n_count[0] += pl[c].count;
    }
  }
  for (; c >= 0; c = pl[c].next[axis]) {
    pl[c].flag = 1;
    n_right++;
    n_count[1] += pl[c].count;
  }
  if (!n_right) {
    const int split_val = pl[nd.tail[axis]].v[axis];
    for (c = nd.tail[axis]; c >= 0; c = pl[c].prev[axis]) {
      if (split_val != pl[c].v[axis]) break;
      pl[c].flag = 1;
      n_count[0] -= pl[c].count;
      n_count[1] += pl[c].count;
    }
  }
  BoxNode kids[2];
  for (int i = 0; i < 3; i++) {
    int32_t l = -1, r = -1;
    kids[0].head[i] = kids[1].head[i] = -1;
    for (c = nd.head[i]; c >= 0;) {
      const int32_t n = pl[c].next[i];
      int32_t& end = pl[c].flag ? r : l;
      const int side = pl[c].flag ? 1 : 0;
      if (end >= 0) {
        pl[end].next[i] = c;
      } else {
        kids[side].head[i] = c;
      }
      pl[c].prev[i] = end;
      end = c;
      c = n;
    }
    if (l >= 0) pl[l].next[i] = -1;
    if (r >= 0) pl[r].next[i] = -1;
    kids[0].tail[i] = l;
    kids[1].tail[i] = r;
  }
  kids[0].pixel_count = n_count[0];
  kids[1].pixel_count = n_count[1];
  boxes.push_back(kids[0]);
  boxes.push_back(kids[1]);
  boxes[node].l = (int32_t)boxes.size() - 2;
  boxes[node].r = (int32_t)boxes.size() - 1;
}

// QuantHeap.c: a max-heap by pixel count, slots from 1
struct Heap {
  std::vector<int32_t> slot{0};
  const std::vector<BoxNode>* boxes;
  int cmp(int32_t a, int32_t b) const {
    return (int)(*boxes)[a].pixel_count - (int)(*boxes)[b].pixel_count;
  }
  void add(int32_t v) {
    slot.push_back(0);
    size_t k = slot.size() - 1;
    while (k != 1) {
      if (cmp(v, slot[k / 2]) <= 0) break;
      slot[k] = slot[k / 2];
      k >>= 1;
    }
    slot[k] = v;
  }
  bool remove(int32_t* r) {
    if (slot.size() <= 1) return false;
    *r = slot[1];
    const int32_t v = slot.back();
    slot.pop_back();
    const size_t count = slot.size() - 1;
    size_t k = 1, l;
    for (; k * 2 <= count; k = l) {
      l = k * 2;
      if (l < count && cmp(slot[l], slot[l + 1]) < 0) l++;
      if (cmp(v, slot[l]) > 0) break;
      slot[k] = slot[l];
    }
    if (count) slot[k] = v;
    return true;
  }
};

void annotate(const std::vector<PixelList>& pl,
              const std::vector<BoxNode>& boxes, int32_t n, HashTable& h,
              uint32_t* box) {
  const BoxNode& b = boxes[n];
  if (b.l >= 0) {
    annotate(pl, boxes, b.l, h, box);
    annotate(pl, boxes, b.r, h, box);
    return;
  }
  const int s = h.scale;
  for (int32_t p = b.head[0]; p >= 0; p = pl[p].next[0]) {
    const uint32_t q = (uint32_t)(pl[p].v[0] << s) |
                       (uint32_t)(pl[p].v[1] << s) << 8 |
                       (uint32_t)(pl[p].v[2] << s) << 16;
    h.insert(q, *box);
  }
  if (b.head[0] >= 0) (*box)++;
}

inline int dist_sqr(const uint8_t* a, const uint8_t* b) {
  const int dr = (int)a[0] - b[0], dg = (int)a[1] - b[1],
            db = (int)a[2] - b[2];
  return dr * dr + dg * dg + db * db;
}

// -- QuantOctree.c ----------------------------------------------------------

struct Bucket {
  uint32_t count;
  uint64_t r, g, b, a;
};

struct Cube {
  unsigned bits[4], width[4], offset[4];
  std::vector<Bucket> buckets;
  Cube(unsigned r, unsigned g, unsigned b, unsigned a) {
    const unsigned in[4] = {r, g, b, a};
    for (int i = 0; i < 4; i++) {
      bits[i] = in[i];
      width[i] = 1u << in[i];
    }
    offset[0] = g + b + a;
    offset[1] = b + a;
    offset[2] = a;
    offset[3] = 0;
    buckets.assign((size_t)width[0] * width[1] * width[2] * width[3],
                   Bucket{0, 0, 0, 0, 0});
  }
  size_t pos(unsigned r, unsigned g, unsigned b, unsigned a) const {
    return r << offset[0] | g << offset[1] | b << offset[2] | a << offset[3];
  }
  Bucket& at(const uint8_t* p) {
    return buckets[pos(p[0] >> (8 - bits[0]), p[1] >> (8 - bits[1]),
                       p[2] >> (8 - bits[2]), p[3] >> (8 - bits[3]))];
  }
  size_t used() const {
    size_t n = 0;
    for (const Bucket& b : buckets) n += b.count > 0;
    return n;
  }
};

inline uint8_t clip8(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// the mean colour of a bucket in float, as avg_color_from_color_bucket
void bucket_mean(const Bucket& b, uint8_t* dst) {
  const float count = (float)b.count;
  if (count != 0) {
    dst[0] = clip8((int)((float)b.r / count));
    dst[1] = clip8((int)((float)b.g / count));
    dst[2] = clip8((int)((float)b.b / count));
    dst[3] = clip8((int)((float)b.a / count));
  } else {
    dst[0] = dst[1] = dst[2] = dst[3] = 0;
  }
}

// copy_color_cube: each axis walks the wider of the two cubes; the
// narrower side's index is shifted down
Cube copy_cube(const Cube& src, unsigned r, unsigned g, unsigned b,
               unsigned a) {
  Cube dst(r, g, b, a);
  unsigned sred[4] = {0, 0, 0, 0}, dred[4] = {0, 0, 0, 0}, width[4];
  for (int i = 0; i < 4; i++) {
    if (src.bits[i] > dst.bits[i]) {
      dred[i] = src.bits[i] - dst.bits[i];
      width[i] = src.width[i];
    } else {
      sred[i] = dst.bits[i] - src.bits[i];
      width[i] = dst.width[i];
    }
  }
  for (unsigned x = 0; x < width[0]; x++)
    for (unsigned y = 0; y < width[1]; y++)
      for (unsigned z = 0; z < width[2]; z++)
        for (unsigned w = 0; w < width[3]; w++) {
          const Bucket& s = src.buckets[src.pos(x >> sred[0], y >> sred[1],
                                                z >> sred[2], w >> sred[3])];
          Bucket& d = dst.buckets[dst.pos(x >> dred[0], y >> dred[1],
                                          z >> dred[2], w >> dred[3])];
          d.count += s.count;
          d.r += s.r;
          d.g += s.g;
          d.b += s.b;
          d.a += s.a;
        }
  return dst;
}

// glibc's qsort: a top-down merge sort (n / 2 first), taking the first
// run's element while the comparison is <= 0; with QuantOctree.c's
// compare_bucket_count, (int)(b->count - a->count), which orders counts
// that wrapped below zero as it does
void msort(uint32_t* b, uint32_t* tmp, size_t n, const Bucket* bk) {
  if (n <= 1) return;
  const size_t n1 = n / 2;
  msort(b, tmp, n1, bk);
  msort(b + n1, tmp, n - n1, bk);
  size_t i = 0, j = n1, k = 0;
  while (i < n1 && j < n) {
    if ((int)(bk[b[j]].count - bk[b[i]].count) <= 0) {
      tmp[k++] = b[i++];
    } else {
      tmp[k++] = b[j++];
    }
  }
  while (i < n1) tmp[k++] = b[i++];
  memcpy(b, tmp, k * sizeof(uint32_t));
}

std::vector<Bucket> sorted_palette(const Cube& cube) {
  const size_t n = cube.buckets.size();
  std::vector<uint32_t> order(n), tmp(n);
  for (size_t i = 0; i < n; i++) order[i] = (uint32_t)i;
  msort(order.data(), tmp.data(), n, cube.buckets.data());
  std::vector<Bucket> out(n);
  for (size_t i = 0; i < n; i++) out[i] = cube.buckets[order[i]];
  return out;
}

void subtract(Cube& cube, const Bucket* buckets, long n) {
  uint8_t p[4];
  for (long i = 0; i < n; i++) {
    const Bucket& s = buckets[i];
    if (s.count == 0) continue;
    bucket_mean(s, p);
    Bucket& m = cube.at(p);
    m.count -= s.count;
    m.r -= s.r;
    m.g -= s.g;
    m.b -= s.b;
    m.a -= s.a;
  }
}

void add_lookup(Cube& cube, const std::vector<Bucket>& palette, long n,
                long offset) {
  uint8_t p[4];
  for (long i = offset + n - 1; i >= offset; i--) {
    bucket_mean(palette[i], p);
    cube.at(p).count = (uint32_t)i;
  }
}

}  // namespace

extern "C" {

// The median cut of n pixels to at most `colors` entries: indices into
// idx, the palette's r, g, b (and 0) into pal (256 x 4).  Returns the
// number of palette entries, or -1 for an argument Pillow refuses.
long long unmicst_quant_median_cut(const uint8_t* px, long long n,
                                   int colors, uint8_t* idx, uint8_t* pal) {
  if (n <= 0 || colors < 1 || colors > 256) return -1;
  HashTable h;
  for (long long i = 0; i < n; i++) {
    const uint8_t* p = px + 4 * i;
    h.count_pixel(p[0] | p[1] << 8 | p[2] << 16);
    while (h.count > kMaxHashEntries) {
      h.scale++;
      h.rehash(h.table.size(), true);
    }
  }
  // hash_to_list: each entry put in front of the three lists
  std::vector<PixelList> pl;
  pl.reserve(h.count);
  int32_t heads[3] = {-1, -1, -1};
  for (int32_t bucket : h.table) {
    for (int32_t nd = bucket; nd >= 0; nd = h.nodes[nd].next) {
      PixelList e;
      const uint32_t key = h.nodes[nd].key;
      for (int i = 0; i < 3; i++) {
        e.v[i] = (uint8_t)(((key >> (8 * i)) & 255) >> h.scale);
        e.next[i] = heads[i];
        e.prev[i] = -1;
      }
      e.flag = 0;
      e.count = h.nodes[nd].value;
      pl.push_back(e);
      const int32_t me = (int32_t)pl.size() - 1;
      for (int i = 0; i < 3; i++) {
        if (heads[i] >= 0) pl[heads[i]].prev[i] = me;
        heads[i] = me;
      }
    }
  }
  for (int i = 0; i < 3; i++) heads[i] = mergesort_pixels(pl, heads[i], i);
  std::vector<BoxNode> boxes(1);
  boxes.reserve(2 * colors + 1);
  for (int i = 0; i < 3; i++) {
    int32_t t = heads[i];
    while (t >= 0 && pl[t].next[i] >= 0) t = pl[t].next[i];
    boxes[0].head[i] = heads[i];
    boxes[0].tail[i] = t;
  }
  boxes[0].pixel_count = (uint32_t)n;
  Heap heap;
  heap.boxes = &boxes;
  heap.add(0);
  for (int left = colors; --left;) {
    int32_t node;
    bool done = false;
    do {
      if (!heap.remove(&node)) {
        done = true;
        break;
      }
    } while (box_volume(pl, boxes[node]) == 1);
    if (done) break;
    split(pl, boxes, node);
    heap.add(boxes[node].l);
    heap.add(boxes[node].r);
  }
  uint32_t n_entries = 0;
  annotate(pl, boxes, 0, h, &n_entries);
  // compute_palette_from_median_cut: each box's mean, rounded
  std::vector<uint32_t> box_of(n), sums(3 * n_entries, 0), counts(n_entries);
  for (long long i = 0; i < n; i++) {
    const uint8_t* p = px + 4 * i;
    uint32_t e = 0;
    h.lookup(p[0] | p[1] << 8 | p[2] << 16, &e);
    box_of[i] = e;
    for (int c = 0; c < 3; c++) sums[3 * e + c] += p[c];
    counts[e]++;
  }
  std::vector<uint8_t> palette(4 * n_entries, 0);
  for (uint32_t e = 0; e < n_entries; e++) {
    for (int c = 0; c < 3; c++) {
      palette[4 * e + c] =
          (uint8_t)(int)(.5 + (double)sums[3 * e + c] / (double)counts[e]);
    }
  }
  // build_distance_tables: each entry's others by distance, stably
  std::vector<uint32_t> dist((size_t)n_entries * n_entries);
  std::vector<uint32_t> order((size_t)n_entries * n_entries);
  for (uint32_t i = 0; i < n_entries; i++) {
    for (uint32_t j = 0; j < n_entries; j++) {
      dist[(size_t)i * n_entries + j] =
          dist_sqr(&palette[4 * i], &palette[4 * j]);
    }
    uint32_t* o = &order[(size_t)i * n_entries];
    const uint32_t* d = &dist[(size_t)i * n_entries];
    for (uint32_t j = 0; j < n_entries; j++) o[j] = j;
    std::stable_sort(o, o + n_entries,
                     [d](uint32_t x, uint32_t y) { return d[x] < d[y]; });
  }
  // map_image_pixels_from_median_box, memoised by colour as Pillow's
  // second hash table does
  std::vector<int16_t> memo(1 << 24, -1);
  for (long long i = 0; i < n; i++) {
    const uint8_t* p = px + 4 * i;
    const uint32_t key = p[0] | p[1] << 8 | p[2] << 16;
    if (memo[key] >= 0) {
      idx[i] = (uint8_t)memo[key];
      continue;
    }
    const uint32_t own = box_of[i];
    uint32_t initial = dist_sqr(&palette[4 * own], p);
    uint32_t best = initial, match = own;
    initial <<= 2;
    const uint32_t* o = &order[(size_t)own * n_entries];
    const uint32_t* d = &dist[(size_t)own * n_entries];
    for (uint32_t j = 0; j < n_entries; j++) {
      if (d[o[j]] > initial) break;
      const uint32_t dd = dist_sqr(&palette[4 * o[j]], p);
      if (dd < best) {
        best = dd;
        match = o[j];
      }
    }
    memo[key] = (int16_t)match;
    idx[i] = (uint8_t)match;
  }
  memcpy(pal, palette.data(), palette.size());
  return n_entries;
}

// The fast octree of n pixels to `colors` entries (with_alpha: RGBA's
// cube levels): indices into idx, the palette's r, g, b, a into pal.
// Returns the number of palette entries (colors), or -1.
long long unmicst_quant_octree(const uint8_t* px, long long n, int colors,
                               int with_alpha, uint8_t* idx, uint8_t* pal) {
  if (n <= 0 || colors < 1 || colors > 256) return -1;
  static const unsigned kLevels[8] = {4, 4, 4, 0, 2, 2, 2, 0};
  static const unsigned kLevelsAlpha[8] = {3, 4, 3, 3, 2, 2, 2, 2};
  const unsigned* lv = with_alpha ? kLevelsAlpha : kLevels;
  // ImagingQuantize: in RGBA, every pixel of alpha 0 takes the colour of
  // the first such pixel
  std::vector<uint8_t> own;
  if (with_alpha) {
    own.assign(px, px + 4 * n);
    const uint8_t* first = nullptr;
    for (long long i = 0; i < n; i++) {
      uint8_t* p = &own[4 * i];
      if (p[3]) continue;
      if (!first) {
        first = p;
      } else {
        memcpy(p, first, 3);
      }
    }
    px = own.data();
  }
  Cube fine(lv[0], lv[1], lv[2], lv[3]);
  for (long long i = 0; i < n; i++) {
    const uint8_t* p = px + 4 * i;
    Bucket& b = fine.at(p);
    b.count += 1;
    b.r += p[0];
    b.g += p[1];
    b.b += p[2];
    b.a += p[3];
  }
  Cube coarse = copy_cube(fine, lv[4], lv[5], lv[6], lv[7]);
  unsigned long n_coarse = coarse.used();
  if (n_coarse > (unsigned long)colors) n_coarse = colors;
  unsigned long n_fine = colors - n_coarse;
  std::vector<Bucket> fine_sorted = sorted_palette(fine);
  subtract(coarse, fine_sorted.data(), n_fine);
  while (n_coarse > coarse.used()) {
    const unsigned long done = n_fine;
    n_coarse = coarse.used();
    n_fine = colors - n_coarse;
    subtract(coarse, &fine_sorted[done], n_fine - done);
  }
  std::vector<Bucket> coarse_sorted = sorted_palette(coarse);
  std::vector<Bucket> palette(coarse_sorted.begin(),
                              coarse_sorted.begin() + n_coarse);
  palette.insert(palette.end(), fine_sorted.begin(),
                 fine_sorted.begin() + n_fine);
  Cube coarse_lookup(lv[4], lv[5], lv[6], lv[7]);
  add_lookup(coarse_lookup, palette, n_coarse, 0);
  Cube lookup = copy_cube(coarse_lookup, lv[0], lv[1], lv[2], lv[3]);
  add_lookup(lookup, palette, n_fine, n_coarse);
  for (long long i = 0; i < n; i++) {
    idx[i] = (uint8_t)lookup.at(px + 4 * i).count;
  }
  for (int e = 0; e < colors; e++) bucket_mean(palette[e], pal + 4 * e);
  return colors;
}

}  // extern "C"
