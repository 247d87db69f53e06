// libsamtpu_host: host-side hot paths of the PyTorch port.
//
// A copy of the parts of samtools_tpu/native/samtpu.cc that the port's
// streamed BAQ + census path needs, with no compression library: BGZF
// runs through Python's zlib on a thread pool (samtools_tpu_torch/io/bgzf.py).
//   * BAM record framing              (sam_read1 framing loop analog)
//   * columnar BAM decode             (sizes + record-parallel fill)
//   * the f64 banded glocal BAQ HMM   (htslib sam_prob_realn analog)
//   * the single-core BAQ + census oracle (samtpu_bench_baq_census)
//   * device-eligibility classification and the two-lane census checksum
//   * the mpileup text writer, the ragged row gather of ReadBatch.take and
//     the ragged copy of the numpy row renderer
//   * consensus's per-read preparation (samtpu_nm_init_batch)
//   * samtools stats' batched passes: per-record CRC32 sums (with a CRC32
//     of its own, zlib's polynomial), aux tag lookup, the sorted-block
//     residue (coverage round buffer, GC-depth bins) and the per-base
//     histogram pass that is K12's host branch
//   * the batch SAM text formatter (samtpu_sam_format)
//
// All entry points are plain C ABI for ctypes.  Every function returns a
// negative code on error, >=0 on success.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// BAM record-offset scan: walk block_size-prefixed records.
// Returns the number of records written to out, or
//   -1 corrupt record size / overrun, -2 trailing garbage, -3 out overflow.
int64_t samtpu_bam_scan_offsets(const uint8_t* data, int64_t n,
                                int64_t start, int64_t* out, int64_t cap) {
  int64_t off = start;
  int64_t cnt = 0;
  while (off + 4 <= n) {
    uint32_t bs;
    std::memcpy(&bs, data + off, 4);
    if (bs == 0 || off + 4 + (int64_t)bs > n) return -1;
    if (cnt >= cap) return -3;
    out[cnt++] = off;
    off += 4 + (int64_t)bs;
  }
  if (off != n) return -2;
  return cnt;
}

// Partial scan for streaming: like samtpu_bam_scan_offsets but a trailing
// incomplete record is not an error — *consumed reports the prefix length
// covered by complete records.  Returns record count, -1 corrupt, -3 cap.
int64_t samtpu_bam_scan_partial(const uint8_t* data, int64_t n, int64_t start,
                                int64_t* out, int64_t cap,
                                int64_t* consumed) {
  int64_t off = start;
  int64_t cnt = 0;
  while (off + 4 <= n) {
    uint32_t bs;
    std::memcpy(&bs, data + off, 4);
    if (bs == 0) return -1;
    if (off + 4 + (int64_t)bs > n) break;  // incomplete tail record
    if (cnt >= cap) return -3;
    out[cnt++] = off;
    off += 4 + (int64_t)bs;
  }
  *consumed = off;
  return cnt;
}

// ---------------------------------------------------------------------------
// Columnar BAM record decode (the htslib sam_read1 loop, SoA).  Two passes:
// sizes (ragged prefix sums) then a record-range-parallel field fill.
// Record layout per SAM spec 4.2; seq nibbles unpack to one byte/base.

static const int kFixed = 36;  // block_size..tlen fixed header bytes

// Writes nrec+1 prefix sums per ragged column.  Returns 0 or
//   -1 record overruns the buffer / negative aux length.
int64_t samtpu_bam_decode_sizes(const uint8_t* data, int64_t n,
                                const int64_t* offs, int64_t nrec,
                                int64_t* qname_off, int64_t* cigar_off,
                                int64_t* seq_off, int64_t* aux_off) {
  int64_t q = 0, c = 0, s = 0, a = 0;
  qname_off[0] = cigar_off[0] = seq_off[0] = aux_off[0] = 0;
  for (int64_t i = 0; i < nrec; ++i) {
    int64_t off = offs[i];
    if (off + kFixed > n) return -1;
    uint32_t bs;
    std::memcpy(&bs, data + off, 4);
    if (off + 4 + (int64_t)bs > n || bs < (uint32_t)(kFixed - 4)) return -1;
    uint8_t l_read_name = data[off + 12];
    uint16_t n_cigar;
    std::memcpy(&n_cigar, data + off + 16, 2);
    int32_t l_seq;
    std::memcpy(&l_seq, data + off + 20, 4);
    if (l_seq < 0 || l_read_name == 0) return -1;
    int64_t body = (int64_t)l_read_name + 4 * (int64_t)n_cigar +
                   ((int64_t)l_seq + 1) / 2 + l_seq;
    int64_t aux_len = (int64_t)bs - (kFixed - 4) - body;
    if (aux_len < 0) return -1;
    q += l_read_name - 1;
    c += n_cigar;
    s += l_seq;
    a += aux_len;
    qname_off[i + 1] = q;
    cigar_off[i + 1] = c;
    seq_off[i + 1] = s;
    aux_off[i + 1] = a;
  }
  return 0;
}

// fields bitmask: 1=qname 2=cigar 4=seq 8=qual 16=aux (fixed columns are
// always filled) — the htslib CRAM required-fields analog: tools that only
// need flags/cigar skip the nibble unpack and qual/aux copies entirely.
static void decode_fill_range(const uint8_t* data, const int64_t* offs,
                              const int64_t* qname_off,
                              const int64_t* cigar_off,
                              const int64_t* seq_off, const int64_t* aux_off,
                              int32_t* tid, int64_t* pos, uint8_t* mapq,
                              uint16_t* flag, int32_t* mtid, int64_t* mpos,
                              int64_t* tlen, uint8_t* qname, uint32_t* cigar,
                              uint8_t* seq, uint8_t* qual, uint8_t* aux,
                              int fields, int64_t lo, int64_t hi) {
  for (int64_t i = lo; i < hi; ++i) {
    const uint8_t* r = data + offs[i];
    uint32_t bs;
    std::memcpy(&bs, r, 4);
    int32_t v32;
    std::memcpy(&v32, r + 4, 4);
    tid[i] = v32;
    std::memcpy(&v32, r + 8, 4);
    pos[i] = v32;
    uint8_t l_read_name = r[12];
    mapq[i] = r[13];
    uint16_t n_cigar;
    std::memcpy(&n_cigar, r + 16, 2);
    std::memcpy(&flag[i], r + 18, 2);
    int32_t l_seq;
    std::memcpy(&l_seq, r + 20, 4);
    std::memcpy(&v32, r + 24, 4);
    mtid[i] = v32;
    std::memcpy(&v32, r + 28, 4);
    mpos[i] = v32;
    std::memcpy(&v32, r + 32, 4);
    tlen[i] = v32;
    const uint8_t* p = r + kFixed;
    if (fields & 1)
      std::memcpy(qname + qname_off[i], p, (size_t)l_read_name - 1);
    p += l_read_name;
    if (fields & 2) std::memcpy(cigar + cigar_off[i], p, 4 * (size_t)n_cigar);
    p += 4 * (size_t)n_cigar;
    if (fields & 4) {
      uint8_t* sq = seq + seq_off[i];
      int64_t half = l_seq / 2;
      for (int64_t j = 0; j < half; ++j) {
        uint8_t b = p[j];
        sq[2 * j] = b >> 4;
        sq[2 * j + 1] = b & 0xF;
      }
      if (l_seq & 1) sq[l_seq - 1] = p[half] >> 4;
    }
    p += (l_seq + 1) / 2;
    if (fields & 8) std::memcpy(qual + seq_off[i], p, (size_t)l_seq);
    p += l_seq;
    if (fields & 16) {
      int64_t aux_len = aux_off[i + 1] - aux_off[i];
      std::memcpy(aux + aux_off[i], p, (size_t)aux_len);
    }
    (void)bs;
  }
}

// Fill all columns; flats must be sized per the *_off prefix sums.
int64_t samtpu_bam_decode_fill(
    const uint8_t* data, int64_t n, const int64_t* offs, int64_t nrec,
    const int64_t* qname_off, const int64_t* cigar_off,
    const int64_t* seq_off, const int64_t* aux_off, int32_t* tid,
    int64_t* pos, uint8_t* mapq, uint16_t* flag, int32_t* mtid, int64_t* mpos,
    int64_t* tlen, uint8_t* qname, uint32_t* cigar, uint8_t* seq,
    uint8_t* qual, uint8_t* aux, int fields, int threads) {
  (void)n;
  if (nrec == 0) return 0;
  int nt = threads > 1 ? threads : 1;
  if (nt > nrec) nt = (int)nrec;
  if (nt <= 1) {
    decode_fill_range(data, offs, qname_off, cigar_off, seq_off, aux_off, tid,
                      pos, mapq, flag, mtid, mpos, tlen, qname, cigar, seq,
                      qual, aux, fields, 0, nrec);
    return nrec;
  }
  std::vector<std::thread> ws;
  int64_t per = (nrec + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * per, hi = lo + per < nrec ? lo + per : nrec;
    if (lo >= hi) break;
    ws.emplace_back([=] {
      decode_fill_range(data, offs, qname_off, cigar_off, seq_off, aux_off,
                        tid, pos, mapq, flag, mtid, mpos, tlen, qname, cigar,
                        seq, qual, aux, fields, lo, hi);
    });
  }
  for (auto& w : ws) w.join();
  return nrec;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BAQ (per-Base Alignment Quality): banded glocal pair-HMM, double
// precision, bit-identical to samtools_tpu/ops/baq.py probaln_glocal
// (consumed at the reference's bam_plcmd.c:451 via htslib sam_prob_realn).
// In the port it is the exact host path for the reads the device routes
// away (and the f32 device HMM's risky reads), and the single-core oracle
// the device census is held against.

#include <cmath>

namespace {

// nt16 -> 2-bit int (4 = ambiguous), htslib seq_nt16_int
static const uint8_t kNt16Int[16] = {4, 0, 1, 4, 2, 4, 4, 4,
                                     3, 4, 4, 4, 4, 4, 4, 4};
static const double kEI = 0.25;
static const double kEM = 1.0 / 3.0;
static const double kPD = 0.001;  // probaln_par d
static const double kPE = 0.1;    // probaln_par e

struct BaqWork {  // reusable per-thread DP scratch
  std::vector<double> f, b, s;
  std::vector<int32_t> state;
  std::vector<int32_t> bq;
  std::vector<double> qtab;  // 10^(-q/10) per base
};

// Banded forward/backward posterior decode; ref/query are 0-4 codes.
// Returns 0 on success (state/bq filled), -1 when skipped.
static int probaln_glocal(const uint8_t* ref, int64_t l_ref,
                          const uint8_t* query, int64_t l_query,
                          const uint8_t* iqual, int bandwidth, BaqWork* w) {
  if (l_ref <= 0 || l_query <= 0) return -1;
  int64_t bw = l_ref > l_query ? l_ref : l_query;
  if (bw > bandwidth) bw = bandwidth;
  int64_t dlr = l_ref > l_query ? l_ref - l_query : l_query - l_ref;
  if (bw < dlr) bw = dlr;
  const int64_t bw2 = bw * 2 + 1;
  const int64_t W = bw2 * 3 + 6;
  w->f.assign((size_t)((l_query + 1) * W), 0.0);
  w->b.assign((size_t)((l_query + 1) * W), 0.0);
  w->s.assign((size_t)(l_query + 2), 0.0);
  w->qtab.resize((size_t)l_query);
  w->state.resize((size_t)l_query);
  w->bq.resize((size_t)l_query);
  double* f = w->f.data();
  double* b = w->b.data();
  double* s = w->s.data();
  double* qual = w->qtab.data();
  for (int64_t i = 0; i < l_query; ++i)
    qual[i] = std::pow(10.0, -(double)iqual[i] / 10.0);

  const double sM = 1.0 / (2 * (double)l_query + 2), sI = sM;
  double m[9];
  m[0] = (1 - kPD - kPD) * (1 - sM);
  m[1] = m[2] = kPD * (1 - sM);
  m[3] = (1 - kPE) * (1 - sI);
  m[4] = kPE * (1 - sI);
  m[5] = 0.0;
  m[6] = 1 - kPE;
  m[7] = 0.0;
  m[8] = kPE;
  const double bM = (1 - kPD) / (double)l_ref;
  const double bI = kPD / (double)l_ref;

  auto set_u = [bw](int64_t i, int64_t k) -> int64_t {
    int64_t x = k - i + bw;
    if (x < 0) x = 0;
    return x * 3;
  };
  auto ematch = [&](int64_t rk /*ref index 0-based*/, uint8_t qy,
                    double ql) -> double {
    uint8_t rb = ref[rk];
    if (rb > 3 || qy > 3) return 1.0;
    return rb == qy ? 1.0 - ql : ql * kEM;
  };

  // ---- forward ----
  f[0 * W + set_u(0, 0)] = s[0] = 1.0;
  {  // row 1
    int64_t beg = 1, end = l_ref < bw + 1 ? l_ref : bw + 1;
    double* f1 = f + W;
    double sum = 0.0;
    for (int64_t k = beg; k <= end; ++k) {
      int64_t u = set_u(1, k);
      double e = ematch(k - 1, query[0], qual[0]);
      f1[u] = e * bM;
      f1[u + 1] = kEI * bI;
      sum += f1[u];
      sum += f1[u + 1];
    }
    s[1] = sum;
    int64_t lo = set_u(1, beg), hi = set_u(1, end) + 2;
    for (int64_t u = lo; u <= hi; ++u) f1[u] /= sum;  // divide (not recip)
  }
  for (int64_t i = 2; i <= l_query; ++i) {
    double* fi = f + i * W;
    const double* fi1 = f + (i - 1) * W;
    double ql = qual[i - 1];
    uint8_t qy = query[i - 1];
    int64_t beg = i - bw > 1 ? i - bw : 1;
    int64_t end = i + bw < l_ref ? i + bw : l_ref;
    double sum = 0.0;
    // pass A: match/insert states read only row i-1 — no loop carry,
    // so the compiler can vectorize; identical per-cell math to the
    // fused loop (bit-exact)
    for (int64_t k = beg; k <= end; ++k) {
      int64_t u = set_u(i, k);
      int64_t v11 = set_u(i - 1, k - 1);
      int64_t v10 = set_u(i - 1, k);
      double e = ematch(k - 1, qy, ql);
      fi[u] = e * (m[0] * fi1[v11] + m[3] * fi1[v11 + 1] +
                   m[6] * fi1[v11 + 2]);
      fi[u + 1] = kEI * (m[1] * fi1[v10] + m[4] * fi1[v10 + 1]);
    }
    // pass B: the deletion state carries within the row; the sum keeps
    // the original (u, u+1, u+2 per k) accumulation order
    for (int64_t k = beg; k <= end; ++k) {
      int64_t u = set_u(i, k);
      int64_t v01 = set_u(i, k - 1);
      fi[u + 2] = m[2] * fi[v01] + m[8] * fi[v01 + 2];
      sum += fi[u];
      sum += fi[u + 1];
      sum += fi[u + 2];
    }
    s[i] = sum;
    double inv = 1.0 / sum;
    int64_t lo = set_u(i, beg), hi = set_u(i, end) + 2;
    for (int64_t u = lo; u <= hi; ++u) fi[u] *= inv;  // reciprocal-multiply
  }
  {  // f[l_query+1]
    double total = 0.0;
    const double* fl = f + l_query * W;
    for (int64_t k = 1; k <= l_ref; ++k) {
      int64_t u = set_u(l_query, k);
      if (u < 3 || u >= bw2 * 3 + 3) continue;
      total += fl[u] * sM + fl[u + 1] * sI;
    }
    s[l_query + 1] = total;
  }

  // ---- backward ----
  {
    double* bl = b + l_query * W;
    for (int64_t k = 1; k <= l_ref; ++k) {
      int64_t u = set_u(l_query, k);
      if (u < 3 || u >= bw2 * 3 + 3) continue;
      bl[u] = sM / s[l_query] / s[l_query + 1];
      bl[u + 1] = sI / s[l_query] / s[l_query + 1];
    }
  }
  for (int64_t i = l_query - 1; i >= 1; --i) {
    double* bi = b + i * W;
    const double* bi1 = b + (i + 1) * W;
    double ql1 = qual[i];
    uint8_t qy1 = query[i];
    int64_t beg = i - bw > 1 ? i - bw : 1;
    int64_t end = i + bw < l_ref ? i + bw : l_ref;
    for (int64_t k = end; k >= beg; --k) {
      int64_t u = set_u(i, k);
      int64_t v11 = set_u(i + 1, k + 1);
      int64_t v10 = set_u(i + 1, k);
      int64_t v01 = set_u(i, k + 1);
      double ee;
      if (k >= l_ref)
        ee = 0.0;
      else if (ref[k] > 3 || qy1 > 3)
        ee = 1.0 * bi1[v11];
      else if (ref[k] == qy1)
        ee = (1.0 - ql1) * bi1[v11];
      else
        ee = ql1 * kEM * bi1[v11];
      bi[u] = ee * m[0] + kEI * m[1] * bi1[v10 + 1] + m[2] * bi[v01 + 2];
      bi[u + 1] = ee * m[3] + kEI * m[4] * bi1[v10 + 1];
      bi[u + 2] = ee * m[6] + m[8] * bi[v01 + 2];
    }
    double inv = 1.0 / s[i];
    int64_t lo = set_u(i, beg), hi = set_u(i, end) + 2;
    for (int64_t u = lo; u <= hi; ++u) bi[u] *= inv;
  }

  // ---- posterior decode ----
  for (int64_t i = 1; i <= l_query; ++i) {
    const double* fi = f + i * W;
    const double* bi = b + i * W;
    int64_t beg = i - bw > 1 ? i - bw : 1;
    int64_t end = i + bw < l_ref ? i + bw : l_ref;
    double sum = 0.0, mx = 0.0;
    int64_t max_k = -1;
    for (int64_t k = beg; k <= end; ++k) {
      int64_t u = set_u(i, k);
      double z = fi[u] * bi[u];
      if (z > mx) {
        mx = z;
        max_k = (k - 1) << 2 | 0;
      }
      sum += z;
      z = fi[u + 1] * bi[u + 1];
      if (z > mx) {
        mx = z;
        max_k = (k - 1) << 2 | 1;
      }
      sum += z;
    }
    if (mx <= 0.0) {
      max_k = -1;
      mx = 0.0;
    }
    double mxn = sum > 0 ? mx / sum : 0.0;
    w->state[(size_t)(i - 1)] = (int32_t)max_k;
    int kq = mxn < 1.0 ? (int)(-4.343 * std::log1p(-mxn) + 0.499) : 100;
    w->bq[(size_t)(i - 1)] = kq > 100 ? 99 : kq;
  }
  return 0;
}

// One-read sam_prob_realn (recompute path; BQ/ZQ tag handling stays in the
// Python caller).  Matches ops/baq.py sam_prob_realn_single semantics.
// flag: 1 apply, 2 extend.  On success writes capped quals to out_qual
// (l_qseq bytes) and returns 0; returns -1 when BAQ is skipped (caller
// keeps the original quals).
static int baq_one(int64_t pos, const uint32_t* cigar, int64_t n_cigar,
                   const uint8_t* seq_nt16, const uint8_t* qual,
                   int64_t l_qseq, const uint8_t* ref_int, int64_t ref_len,
                   int flag, uint8_t* out_qual, BaqWork* w) {
  const int apply_baq = flag & 1, extend_baq = (flag >> 1) & 1;
  if (l_qseq == 0 || qual[0] == 0xFF) return -1;
  int64_t x = pos, y = 0, xb = -1, yb = -1, xe = -1, ye = -1;
  for (int64_t c = 0; c < n_cigar; ++c) {
    uint32_t op = cigar[c] & 0xF;
    int64_t ln = cigar[c] >> 4;
    if (op == 0 || op == 7 || op == 8) {  // M/=/X
      if (yb < 0) yb = y;
      if (xb < 0) xb = x;
      ye = y + ln;
      xe = x + ln;
      x += ln;
      y += ln;
    } else if (op == 4 || op == 1) {  // S/I
      y += ln;
    } else if (op == 2) {  // D
      x += ln;
    } else if (op == 3) {  // N
      return -1;
    }
  }
  if (xb < 0) return -1;
  int64_t bw = 7;
  int64_t diff = (xe - xb) - (ye - yb);
  if (diff < 0) diff = -diff;
  if (diff > bw) bw = diff + 3;
  xb -= (yb < xb ? yb : xb);  // see ops/baq.py extent-rule note
  xe += l_qseq - ye + bw / 2;
  if (xe > ref_len) xe = ref_len;
  if (xe <= xb) return -1;

  // query as 0-4 codes
  std::vector<uint8_t> q4((size_t)l_qseq);
  for (int64_t i = 0; i < l_qseq; ++i) q4[(size_t)i] = kNt16Int[seq_nt16[i]];
  if (probaln_glocal(ref_int + xb, xe - xb, q4.data(), l_qseq, qual,
                     (int)bw, w) < 0)
    return -1;

  // per-M-op state check + cap + (extended) smoothing
  std::vector<int64_t> bqv((size_t)l_qseq);
  for (int64_t i = 0; i < l_qseq; ++i) bqv[(size_t)i] = w->bq[(size_t)i];
  x = pos;
  y = 0;
  for (int64_t c = 0; c < n_cigar; ++c) {
    uint32_t op = cigar[c] & 0xF;
    int64_t ln = cigar[c] >> 4;
    if (op == 0 || op == 7 || op == 8) {
      for (int64_t i = y; i < y + ln; ++i) {
        int32_t st = w->state[(size_t)i];
        if ((st & 3) != 0 || (st >> 2) != x - xb + (i - y))
          bqv[(size_t)i] = 0;
        else if (bqv[(size_t)i] > qual[i])
          bqv[(size_t)i] = qual[i];
      }
      if (extend_baq && ln > 0) {
        // min(prefix-running-max, suffix-running-max) within the op
        int64_t left = 0;
        std::vector<int64_t> lq((size_t)ln);
        for (int64_t i = 0; i < ln; ++i) {
          if (bqv[(size_t)(y + i)] > left) left = bqv[(size_t)(y + i)];
          lq[(size_t)i] = left;
        }
        int64_t rght = 0;
        for (int64_t i = ln - 1; i >= 0; --i) {
          if (bqv[(size_t)(y + i)] > rght) rght = bqv[(size_t)(y + i)];
          bqv[(size_t)(y + i)] = lq[(size_t)i] < rght ? lq[(size_t)i] : rght;
        }
      }
      x += ln;
      y += ln;
    } else if (op == 4 || op == 1) {
      y += ln;
    } else if (op == 2) {
      x += ln;
    }
  }
  // final: apply via the 64-offset tag arithmetic (ops/baq.py final_bq).
  // extend mode: newq = q - max(0, q - bqv) = min(q, bqv).
  // non-extend:  newq = q - ((q - bqv + 64) - 64) = bqv — soft-clip/insert
  // bases (never capped by the per-M loop) CAN be raised above q, exactly
  // as htslib's qual - (BQ - 64) arithmetic allows.
  for (int64_t i = 0; i < l_qseq; ++i) {
    int64_t q = qual[i];
    int64_t newq = q;
    if (apply_baq) {
      if (extend_baq)
        newq = q <= bqv[(size_t)i] ? q : bqv[(size_t)i];
      else
        newq = bqv[(size_t)i];
    }
    if (newq < 0) newq = 0;
    if (newq > 255) newq = 255;
    out_qual[i] = (uint8_t)newq;
  }
  return 0;
}

}  // namespace

extern "C" {

// Columnar batched BAQ over decoded arrays (the framework's host fast
// path).  seq holds unpacked nt16 codes, ref_int 0-4 contig codes.
// out_qual must be a copy of qual (skipped reads keep originals);
// skipped[i]=1 marks reads where BAQ did not apply.  Thread-parallel
// over reads (each read independent).  Returns n or <0 on error.
int64_t samtpu_baq_batch(const int64_t* pos, const uint32_t* cigar,
                         const int64_t* cigar_off, const uint8_t* seq,
                         const uint8_t* qual, const int64_t* seq_off,
                         int64_t n, const uint8_t* ref_int, int64_t ref_len,
                         int flag, uint8_t* out_qual, uint8_t* skipped,
                         int threads) {
  std::atomic<int64_t> err{0};
  auto work = [&](int64_t lo, int64_t hi) {
    BaqWork w;
    for (int64_t i = lo; i < hi; ++i) {
      int64_t lq = seq_off[i + 1] - seq_off[i];
      int rc = baq_one(pos[i], cigar + cigar_off[i],
                       cigar_off[i + 1] - cigar_off[i], seq + seq_off[i],
                       qual + seq_off[i], lq, ref_int, ref_len, flag,
                       out_qual + seq_off[i], &w);
      skipped[i] = rc < 0 ? 1 : 0;
    }
  };
  int nt = threads > 1 ? threads : 1;
  if (nt > n) nt = n > 0 ? (int)n : 1;
  if (nt <= 1) {
    work(0, n);
  } else {
    std::vector<std::thread> ws;
    int64_t per = (n + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      int64_t lo = t * per, hi = lo + per < n ? lo + per : n;
      if (lo >= hi) break;
      ws.emplace_back(work, lo, hi);
    }
    for (auto& w2 : ws) w2.join();
  }
  if (err.load() < 0) return err.load();
  return n;
}

// Single-core reference pipeline (the census oracle): the mpileup-with-BAQ
// architecture (bam_plcmd.c:451 sam_prob_realn + :607 column loop) as one
// measured loop: walk records, BAQ-adjust quals, accumulate the
// per-position base census gated at min_baseq.  census: int32[ref_len*5]
// (A,C,G,T,other by seq_nt16_int), qsum: int64[ref_len] summed capped
// quals of counted bases.  Returns records processed.
int64_t samtpu_bench_baq_census(const uint8_t* data, int64_t n,
                                int32_t want_tid, const uint8_t* ref_int,
                                int64_t ref_len, int excl_flags, int min_mapq,
                                int min_baseq, int baq_flag, int32_t* census,
                                int64_t* qsum) {
  int64_t off = 0, cnt = 0;
  BaqWork w;
  std::vector<uint8_t> seq4;
  std::vector<uint8_t> bq;
  while (off + 4 <= n) {
    uint32_t bs;
    std::memcpy(&bs, data + off, 4);
    if (bs == 0 || off + 4 + (int64_t)bs > n) return -1;
    const uint8_t* r = data + off;
    off += 4 + (int64_t)bs;
    int32_t tid;
    std::memcpy(&tid, r + 4, 4);
    uint16_t flag;
    std::memcpy(&flag, r + 18, 2);
    if (tid != want_tid || (flag & excl_flags)) continue;
    if (r[13] < min_mapq) continue;
    int32_t pos;
    std::memcpy(&pos, r + 8, 4);
    uint8_t l_read_name = r[12];
    uint16_t n_cigar;
    std::memcpy(&n_cigar, r + 16, 2);
    int32_t l_seq;
    std::memcpy(&l_seq, r + 20, 4);
    // derived cigar/seq/qual spans must fit inside the record (guards
    // out-of-bounds reads on malformed bodies, as samtpu_bam_decode_sizes
    // does)
    if (l_seq < 0 || l_read_name == 0 ||
        (int64_t)kFixed - 4 + l_read_name + 4 * (int64_t)n_cigar +
                ((int64_t)l_seq + 1) / 2 + (int64_t)l_seq >
            (int64_t)bs)
      return -1;
    const uint32_t* cig =
        reinterpret_cast<const uint32_t*>(r + kFixed + l_read_name);
    const uint8_t* packed = r + kFixed + l_read_name + 4 * n_cigar;
    const uint8_t* qual = packed + (l_seq + 1) / 2;
    // unpack nibbles
    seq4.resize((size_t)l_seq);
    for (int32_t j = 0; j < l_seq / 2; ++j) {
      seq4[(size_t)(2 * j)] = packed[j] >> 4;
      seq4[(size_t)(2 * j + 1)] = packed[j] & 0xF;
    }
    if (l_seq & 1) seq4[(size_t)(l_seq - 1)] = packed[l_seq / 2] >> 4;
    bq.assign(qual, qual + l_seq);
    if (baq_flag)
      baq_one(pos, cig, n_cigar, seq4.data(), qual, l_seq, ref_int, ref_len,
              baq_flag, bq.data(), &w);
    // census accumulate (M/=/X bases, min_baseq gate)
    int64_t rp = pos, qp = 0;
    for (uint16_t k = 0; k < n_cigar; ++k) {
      uint32_t op = cig[k] & 0xF, len = cig[k] >> 4;
      switch (op) {
        case 0:
        case 7:
        case 8:
          for (uint32_t j = 0; j < len; ++j) {
            int64_t p2 = rp + j;
            if (p2 < 0 || p2 >= ref_len) continue;
            uint8_t q = bq[(size_t)(qp + j)];
            if (q < min_baseq) continue;
            census[p2 * 5 + kNt16Int[seq4[(size_t)(qp + j)]]]++;
            qsum[p2] += q;
          }
          rp += len;
          qp += len;
          break;
        case 1:
        case 4:
          qp += len;
          break;
        case 2:
        case 3:
          rp += len;
          break;
        default:
          break;
      }
    }
    ++cnt;
  }
  return cnt;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Device-eligibility classification for the fused BAQ+census pipeline
// (mirrors ops/mpileup_device.classify_reads, the vectorized analog of
// baq_one's alignment-extent walk above).  For each selected read computes
// whether the uniform-shape device kernel can ingest it (<= maxops cigar
// ops, exact l_query, M-extent band within bw, window inside the contig)
// plus the per-read HMM window parameters (lead, lref) and the padded
// cigar row.  lead/lref are valid only where elig[i] != 0.
// Thread-parallel over reads.  Returns n.

extern "C" int64_t samtpu_classify_reads(
    const int64_t* pos, const uint32_t* cigar, const int64_t* cigar_off,
    const int64_t* seq_off, const uint8_t* qual, int64_t qual_size,
    const int64_t* sel, int64_t n, int64_t l_query, int64_t ref_len,
    int64_t bw, int64_t maxops, uint8_t* elig, int64_t* lead,
    int64_t* lref, uint32_t* cig8, int threads) {
  auto work = [&](int64_t lo0, int64_t hi0) {
    for (int64_t i = lo0; i < hi0; ++i) {
      int64_t r = sel[i];
      int64_t nc = cigar_off[r + 1] - cigar_off[r];
      int64_t lq = seq_off[r + 1] - seq_off[r];
      int64_t p = pos[r];
      uint32_t* crow = cig8 + i * maxops;
      int64_t ncc = nc < maxops ? nc : maxops;
      for (int64_t j = 0; j < ncc; ++j) crow[j] = cigar[cigar_off[r] + j];
      for (int64_t j = ncc < 0 ? 0 : ncc; j < maxops; ++j) crow[j] = 0;
      lead[i] = 0;
      lref[i] = 0;
      bool ok = nc >= 1 && nc <= maxops && lq == l_query && p >= 0 &&
                p + l_query + 16 < (int64_t)1 << 31;
      if (!ok) { elig[i] = 0; continue; }
      // walk the (<= maxops) ops: query/ref spans + first/last M extent
      int64_t qpos = 0, rpos = 0;
      int64_t yb = -1, xbM = -1, ye = -1, xeM = -1;
      bool has_m = false;
      for (int64_t j = 0; j < nc; ++j) {
        uint32_t op = crow[j] & 0xF;
        int64_t ln = (int64_t)(crow[j] >> 4);
        if (op == 3 || op > 8) { ok = false; break; }  // N/B -> host
        bool is_m = (op == 0 || op == 7 || op == 8) && ln > 0;
        if (is_m) {
          if (!has_m) { yb = qpos; xbM = p + rpos; has_m = true; }
          ye = qpos + ln;
          xeM = p + rpos + ln;
        }
        if (is_m || op == 1 || op == 4) qpos += ln;
        if (is_m || op == 2) rpos += ln;
      }
      if (!ok || !has_m) { elig[i] = 0; continue; }
      int64_t diff = (xeM - xbM) - (ye - yb);
      if (diff < 0) diff = -diff;
      if (diff > bw) { elig[i] = 0; continue; }
      int64_t ld = yb < xbM ? yb : xbM;
      int64_t xb = xbM - ld;
      int64_t xe = xeM + (l_query - ye) + bw / 2;
      int64_t lr = xe - xb;
      int64_t dl = lr - l_query;
      if (dl < 0) dl = -dl;
      if (xe > ref_len || xb < 0 || dl > bw) { elig[i] = 0; continue; }
      if (qual_size > 0) {
        int64_t q0 = seq_off[r];
        if (q0 > qual_size - 1) q0 = qual_size - 1;
        if (qual[q0] == 0xFF) { elig[i] = 0; continue; }
      }
      elig[i] = 1;
      lead[i] = ld;
      lref[i] = lr;
    }
  };
  int nt = threads > 1 ? threads : 1;
  if (nt > n) nt = n > 0 ? (int)n : 1;
  if (nt <= 1) {
    work(0, n);
  } else {
    std::vector<std::thread> ws;
    int64_t per = (n + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      int64_t lo = t * per, hi = lo + per < n ? lo + per : n;
      if (lo >= hi) break;
      ws.emplace_back(work, lo, hi);
    }
    for (auto& w : ws) w.join();
  }
  return n;
}

// Two-lane weighted census checksum — identical math to
// ops/mpileup_device.census_checksum (uint32 wrap-around accumulation over
// [census.ravel(), qsum] with index-derived weights).  census is
// int64[wlen*5] row-major, qsum int64[wlen]; writes {s1, s2} to out2.
extern "C" void samtpu_census_checksum(const int64_t* census,
                                       const int64_t* qsum, int64_t wlen,
                                       uint32_t* out2) {
  uint32_t s1 = 0, s2 = 0;
  uint32_t idx = 0;
  const int64_t n5 = wlen * 5;
  for (int64_t i = 0; i < n5; ++i, ++idx) {
    uint32_t v = (uint32_t)(uint64_t)census[i];
    s1 += v * (idx * 2654435761u);
    s2 += v * ((idx + 0x9E3779B9u) * 40503u);
  }
  for (int64_t i = 0; i < wlen; ++i, ++idx) {
    uint32_t v = (uint32_t)(uint64_t)qsum[i];
    s1 += v * (idx * 2654435761u);
    s2 += v * ((idx + 0x9E3779B9u) * 40503u);
  }
  out2[0] = s1;
  out2[1] = s2;
}

// ---------------------------------------------------------------------------
// Native mpileup text writer (host formatting engine; a copy of the JAX
// package's samtools_tpu/native/samtpu.cc writer).
//
// Default-column pileup text for one window of a single input file:
// counting-sort the per-base entries into column-major slots (two cigar
// walks), then emit rows in samtools' grammar (bam_plcmd.c pileup_seq and
// its column loop).  BAQ / overlap tweaks / flag filters / depth caps are
// applied by the caller before this runs; this is purely the
// pileup+format stage.  Columns are emitted for [emit_beg, emit_end)
// only (window ownership); reads may extend beyond (halo).

namespace {

struct TextBuf {
  uint8_t* p = nullptr;
  int64_t len = 0, cap = 0;
  bool grow(int64_t need) {
    if (len + need <= cap) return true;
    int64_t nc = cap ? cap * 2 : (1 << 20);
    while (nc < len + need) nc *= 2;
    uint8_t* np_ = (uint8_t*)realloc(p, (size_t)nc);
    if (!np_) return false;
    p = np_;
    cap = nc;
    return true;
  }
  inline void put(uint8_t c) { p[len++] = c; }
  inline void put_bytes(const void* s, int64_t n) {
    std::memcpy(p + len, s, (size_t)n);
    len += n;
  }
  inline void put_u64(uint64_t v) {
    char tmp[20];
    int k = 0;
    do {
      tmp[k++] = (char)('0' + v % 10);
      v /= 10;
    } while (v);
    while (k) p[len++] = (uint8_t)tmp[--k];
  }
};

// display char tables: nt16 code (0 = ref match -> '.'/',')
static const char kSeqUC[16] = {'.', 'A', 'C', 'M', 'G', 'R', 'S', 'V',
                                'T', 'W', 'Y', 'H', 'K', 'D', 'B', 'N'};
static const char kSeqLC[16] = {',', 'a', 'c', 'm', 'g', 'r', 's', 'v',
                                't', 'w', 'y', 'h', 'k', 'd', 'b', 'n'};
// raw nt16 -> base letter (insertion strings; 0 = '=')
static const char kNt16Chr[16] = {'=', 'A', 'C', 'M', 'G', 'R', 'S', 'V',
                                  'T', 'W', 'Y', 'H', 'K', 'D', 'B', 'N'};

// ASCII base -> nt16 code (the SAM text parser table)
static int8_t kAscNt16[256];
static bool init_asc_nt16() {
  const char* s = "=ACMGRSVTWYHKDBN";
  for (int i = 0; i < 256; ++i) kAscNt16[i] = 15;
  for (int i = 0; i < 16; ++i) {
    kAscNt16[(uint8_t)s[i]] = (int8_t)i;
    kAscNt16[(uint8_t)(s[i] | 32)] = (int8_t)i;
  }
  return true;
}
static const bool kAscInit = init_asc_nt16();

static inline char lower_ascii(char c) {
  return (c >= 'A' && c <= 'Z') ? (char)(c | 32) : c;
}
static inline char upper_ascii(char c) {
  return (c >= 'a' && c <= 'z') ? (char)(c & ~32) : c;
}

// per-entry slot payload
struct PlSlot {
  uint8_t ch;      // display char
  uint8_t qch;     // qual char
  uint8_t bits;    // 1 pass, 2 head, 4 tail
  uint8_t mqch;    // ^ marker qual char
  uint32_t piece;  // index+1 into the special piece table, 0 = plain
};

static inline bool is_entry_op(uint32_t op) {
  return op == 0 || op == 7 || op == 8 || op == 2 || op == 3;
}

}  // namespace

extern "C" {

void samtpu_buf_free(uint8_t* p) { free(p); }

int64_t samtpu_mpileup_text(
    const int64_t* pos, int64_t n, const uint16_t* flag,
    const uint8_t* mapq, const uint32_t* cigar, const int64_t* cigar_off,
    const uint8_t* seq, const uint8_t* qual, const int64_t* seq_off,
    const uint8_t* ref, int64_t ref_len, const uint8_t* name,
    int64_t name_len, int64_t emit_beg, int64_t emit_end, int all_mode,
    const uint8_t* bedmask, int min_baseq, int rev_del, int no_ends,
    int no_ins, int no_del, uint8_t** out, int64_t* out_len) {
  (void)kAscInit;
  if (emit_end < emit_beg) return -1;
  const int64_t W = emit_end - emit_beg;
  std::vector<int32_t> cnt((size_t)W + 1, 0);
  // ---- pass 1: count entries per column
  for (int64_t r = 0; r < n; ++r) {
    int64_t x = pos[r];
    for (int64_t c = cigar_off[r]; c < cigar_off[r + 1]; ++c) {
      uint32_t op = cigar[c] & 0xF;
      int64_t ln = cigar[c] >> 4;
      if (is_entry_op(op)) {
        int64_t lo = x > emit_beg ? x : emit_beg;
        int64_t hi = x + ln < emit_end ? x + ln : emit_end;
        for (int64_t p2 = lo; p2 < hi; ++p2)
          cnt[(size_t)(p2 - emit_beg)]++;
        x += ln;
      }
    }
  }
  std::vector<int64_t> col_off((size_t)W + 1);
  int64_t tot = 0;
  for (int64_t i = 0; i < W; ++i) {
    col_off[(size_t)i] = tot;
    tot += cnt[(size_t)i];
    cnt[(size_t)i] = 0;  // becomes the running cursor in pass 2
  }
  col_off[(size_t)W] = tot;
  std::vector<PlSlot> slots((size_t)tot);
  std::vector<uint8_t> arena;  // special piece bytes
  std::vector<int64_t> arena_off(1, 0);

  // ---- pass 2: scatter entries (walk order == arrival order per column)
  for (int64_t r = 0; r < n; ++r) {
    const int64_t c0 = cigar_off[r], c1 = cigar_off[r + 1];
    const int64_t lq = seq_off[r + 1] - seq_off[r];
    const uint8_t* sq = seq + seq_off[r];
    const uint8_t* qu = qual + seq_off[r];
    const bool rev = (flag[r] & 16) != 0;
    int64_t endp = pos[r];
    for (int64_t c = c0; c < c1; ++c)
      if (is_entry_op(cigar[c] & 0xF)) endp += cigar[c] >> 4;
    const uint8_t mqch =
        (uint8_t)(mapq[r] + 33 < 126 ? mapq[r] + 33 : 126);
    int64_t x = pos[r], y = 0;
    for (int64_t c = c0; c < c1; ++c) {
      uint32_t op = cigar[c] & 0xF;
      int64_t ln = cigar[c] >> 4;
      if (!is_entry_op(op)) {
        if (op == 1 || op == 4) y += ln;  // I/S consume query
        continue;
      }
      bool is_m = (op == 0 || op == 7 || op == 8);
      int64_t last_slot = -1;  // slot of this op's final entry
      for (int64_t j = 0; j < ln; ++j) {
        int64_t p2 = x + j;
        if (p2 < emit_beg || p2 >= emit_end) continue;
        int64_t qp = is_m ? y + j : y;  // frozen at op start in D/N
        int64_t rel = p2 - emit_beg;
        int64_t slot = col_off[(size_t)rel] + cnt[(size_t)rel]++;
        PlSlot& S = slots[(size_t)slot];
        int code = (qp < lq) ? sq[qp] : 15;
        int qv = (qp < lq) ? qu[qp] : 0;
        uint8_t ch;
        if (!is_m) {
          ch = (op == 3) ? (rev ? '<' : '>')
                         : ((rev && rev_del) ? '#' : '*');
        } else {
          if (ref) {
            int rb = (p2 < ref_len) ? kAscNt16[ref[p2]] : 15;
            if (code == rb) code = 0;
          }
          ch = (uint8_t)(rev ? kSeqLC[code] : kSeqUC[code]);
        }
        S.ch = ch;
        S.qch = (uint8_t)(qv + 33 < 126 ? qv + 33 : 126);
        S.mqch = mqch;
        S.piece = 0;
        uint8_t bits = 0;
        if (qv >= min_baseq) bits |= 1;
        if (p2 == pos[r] && !no_ends) bits |= 2;
        if (p2 == endp - 1 && !no_ends) bits |= 4;
        S.bits = bits;
        if (j == ln - 1) last_slot = slot;
      }
      int64_t y_after = is_m ? y + ln : y;
      int64_t x_after = x + ln;
      // ---- indel annotation for the run after this op
      // (pileup.py build_pileup run-scan: next entry op is q; the run
      // between collects I bases and P pads, terminated by S/H; a run
      // with I -> insertion string (+ del_after if op[q] is D); an
      // empty or ins-less run before a D -> plain deletion)
      int64_t qn = c + 1;
      while (qn < c1 && !is_entry_op(cigar[qn] & 0xF)) ++qn;
      bool has_ins = false;
      std::string insstr;
      {
        int64_t yy = y_after;
        for (int64_t k = c + 1; k < qn; ++k) {
          uint32_t o2 = cigar[k] & 0xF;
          int64_t l2 = cigar[k] >> 4;
          if (o2 == 1) {  // I
            has_ins = true;
            int64_t avail = lq - yy > 0 ? lq - yy : 0;
            int64_t take = l2 < avail ? l2 : avail;
            if (take > 0)
              for (int64_t t2 = 0; t2 < take; ++t2)
                insstr.push_back(kNt16Chr[sq[yy + t2] & 0xF]);
            else
              insstr.append((size_t)l2, 'N');
            yy += l2;
          } else if (o2 == 6) {  // P
            insstr.append((size_t)l2, '*');
          } else {  // S/H terminate the ins/pad scan
            break;
          }
        }
      }
      int64_t del_after =
          (qn < c1 && (cigar[qn] & 0xF) == 2) ? (cigar[qn] >> 4) : 0;
      bool annotate = has_ins || del_after > 0;
      int64_t lastp = x_after - 1;
      if (annotate && ln > 0 && last_slot >= 0 && lastp >= emit_beg &&
          lastp < emit_end) {
        PlSlot& A = slots[(size_t)last_slot];
        std::string s2;
        if (A.bits & 2) {
          s2.push_back('^');
          s2.push_back((char)A.mqch);
        }
        s2.push_back((char)A.ch);
        if (has_ins) {
          if (no_ins < 2) {
            s2.push_back('+');
            s2 += std::to_string(insstr.size());
          }
          if (!no_ins) {
            for (char cc : insstr) {
              if (cc == '*')
                s2.push_back((rev && rev_del) ? '#' : '*');
              else
                s2.push_back(rev ? lower_ascii(cc) : cc);
            }
          }
        }
        if (del_after > 0) {
          if (no_del < 2) {
            s2.push_back('-');
            s2 += std::to_string(del_after);
          }
          if (!no_del) {
            // deleted reference bases start right after the anchor
            for (int64_t j2 = 0; j2 < del_after; ++j2) {
              int64_t pj = x_after + j2;
              char rc = (ref && pj < ref_len) ? (char)ref[pj] : 'N';
              s2.push_back(rev ? lower_ascii(rc) : upper_ascii(rc));
            }
          }
        }
        if (A.bits & 4) s2.push_back('$');
        arena.insert(arena.end(), s2.begin(), s2.end());
        arena_off.push_back((int64_t)arena.size());
        A.piece = (uint32_t)(arena_off.size() - 1);
      }
      x = x_after;
      y = y_after;
    }
  }

  // ---- pass 3: emit rows
  TextBuf tb;
  for (int64_t rel = 0; rel < W; ++rel) {
    int64_t lo = col_off[(size_t)rel], hi = col_off[(size_t)rel + 1];
    if (lo == hi && !all_mode) continue;
    if (bedmask && !bedmask[rel]) continue;
    int64_t p2 = emit_beg + rel;
    int64_t npass = 0, pbytes = 0;
    for (int64_t s = lo; s < hi; ++s) {
      const PlSlot& S = slots[(size_t)s];
      if (!(S.bits & 1)) continue;
      ++npass;
      if (S.piece)
        pbytes += arena_off[S.piece] - arena_off[S.piece - 1];
      else
        pbytes += 1 + ((S.bits & 2) ? 2 : 0) + ((S.bits & 4) ? 1 : 0);
    }
    if (!tb.grow(name_len + 64 + pbytes + npass)) {
      free(tb.p);
      return -1;
    }
    tb.put_bytes(name, name_len);
    tb.put('\t');
    tb.put_u64((uint64_t)(p2 + 1));
    tb.put('\t');
    tb.put((ref && p2 < ref_len) ? ref[p2] : (uint8_t)'N');
    tb.put('\t');
    tb.put_u64((uint64_t)npass);
    tb.put('\t');
    if (npass == 0) {
      tb.put('*');
      tb.put('\t');
      tb.put('*');
    } else {
      for (int64_t s = lo; s < hi; ++s) {
        const PlSlot& S = slots[(size_t)s];
        if (!(S.bits & 1)) continue;
        if (S.piece) {
          tb.put_bytes(arena.data() + arena_off[S.piece - 1],
                       arena_off[S.piece] - arena_off[S.piece - 1]);
        } else {
          if (S.bits & 2) {
            tb.put('^');
            tb.put(S.mqch);
          }
          tb.put(S.ch);
          if (S.bits & 4) tb.put('$');
        }
      }
      tb.put('\t');
      for (int64_t s = lo; s < hi; ++s) {
        const PlSlot& S = slots[(size_t)s];
        if (S.bits & 1) tb.put(S.qch);
      }
    }
    tb.put('\n');
  }
  if (!tb.p) {
    // zero rows: hand back a valid empty buffer
    tb.grow(1);
    tb.len = 0;
  }
  *out = tb.p;
  *out_len = tb.len;
  return tb.len;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Ragged row gather: out[k] slice = flat[off[rows[k]] : off[rows[k]+1]].
// The columnar take() operation's hot path — per-row memcpy avoids
// materializing index arrays as large as the payload (a cumsum-built
// gather index costs two extra full passes at numpy speed).
// itemsize-agnostic: offsets count ITEMS, copies are bytes.

extern "C" {

int64_t samtpu_ragged_gather(const uint8_t* flat, const int64_t* off,
                             const int64_t* rows, int64_t m,
                             const int64_t* out_off, uint8_t* out,
                             int64_t itemsize, int threads) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) {
      int64_t r = rows[k];
      int64_t s = off[r] * itemsize;
      int64_t nbytes = (off[r + 1] - off[r]) * itemsize;
      if (nbytes > 0) std::memcpy(out + out_off[k] * itemsize, flat + s,
                                  (size_t)nbytes);
    }
  };
  int nt = threads > 1 ? threads : 1;
  if (nt <= 1 || m < (1 << 16)) {
    work(0, m);
    return m;
  }
  std::vector<std::thread> ws;
  int64_t per = (m + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * per, hi = lo + per < m ? lo + per : m;
    if (lo >= hi) break;
    ws.emplace_back([&, lo, hi] { work(lo, hi); });
  }
  for (auto& w : ws) w.join();
  return m;
}

// dst[dst_start[k] : +lens[k]] = src[src_start[k] : +lens[k]] for every
// k < m (bytes; the caller checks the bounds): the row writers' scatter of
// ragged fields into one output buffer.
int64_t samtpu_ragged_copy(uint8_t* dst, const int64_t* dst_start,
                           const uint8_t* src, const int64_t* src_start,
                           const int64_t* lens, int64_t m, int threads) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) {
      if (lens[k] > 0)
        std::memcpy(dst + dst_start[k], src + src_start[k], (size_t)lens[k]);
    }
  };
  int nt = threads > 1 ? threads : 1;
  if (nt <= 1 || m < (1 << 16)) {
    work(0, m);
    return m;
  }
  std::vector<std::thread> ws;
  int64_t per = (m + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * per, hi = lo + per < m ? lo + per : m;
    if (lo >= hi) break;
    ws.emplace_back([&, lo, hi] { work(lo, hi); });
  }
  for (auto& w : ws) w.join();
  return m;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Consensus per-read preparation (bam_consensus.c:1012 nm_init):
// local NM profile + quality adjustment + homopolymer lengths packed
// into the top 8 bits, plus the optional homopolymer qual smoothing
// (:943).  A copy of samtools_tpu/native/samtpu.cc:1325-1517; the port's
// Python per-read nm_init (tools/consensus_cmd.py) is its oracle in the
// tests.

namespace {

static inline double cons_fast_log2(double val) {
  uint64_t x;
  std::memcpy(&x, &val, 8);
  int64_t E = (int64_t)((x >> 52) & 2047) - 1024;
  x &= ~(2047ULL << 52);
  x += 1023ULL << 52;
  double m;
  std::memcpy(&m, &x, 8);
  return (double)E + ((-1.0 / 3.0) * m + 2) * m - 2.0 / 3.0;
}

}  // namespace

extern "C" {

int64_t samtpu_nm_init_batch(
    uint8_t* qual, const uint8_t* seq, const int64_t* seq_off,
    const uint32_t* cigar, const int64_t* cigar_off, const uint8_t* md,
    const int64_t* md_off, int64_t n, int use_mqual, int adj_qual,
    int bayes116, double homopoly_fix, int nm_halo, int sc_cost,
    int32_t* out_nm) {
  if (!use_mqual) return 0;
  const double poly_adj = homopoly_fix != 0.0 ? homopoly_fix : 1.0;
  for (int64_t r = 0; r < n; ++r) {
    const int64_t q0 = seq_off[r];
    const int64_t qlen = seq_off[r + 1] - q0;
    if (qlen <= 0) continue;
    uint8_t* qu = qual + q0;
    const uint8_t* sq = seq + q0;
    int32_t* nm = out_nm + q0;
    for (int64_t i = 0; i < qlen; ++i) nm[i] = 0;

    if (adj_qual) {
      const int64_t qhalo = 8, qhalop = 2;
      int64_t qmin = qu[0], qminp = qu[0];
      int base = sq[0];
      int64_t polyl = 0, polyr = 0;
      for (int64_t i = 1; i < qlen; ++i) {
        if (sq[i] != base) break;
        if (i < qhalop && qminp > qu[i]) qminp = qu[i];
      }
      int64_t i = 0;
      while (i < qlen && i < qhalo) {
        if (qmin > qu[i]) qmin = qu[i];
        ++i;
      }
      while (i < qlen - qhalo) {
        if (homopoly_fix != 0.0 && sq[i] != base) {
          polyl = i;
          base = sq[i];
          qminp = qu[i];
          int64_t j = i + 1;
          while (j < qlen) {
            if (sq[j] != base) break;
            if (i < qhalop && qminp > qu[j]) qminp = qu[j];
            ++j;
          }
          polyr = j - 1;
        } else {
          polyr = polyl;
        }
        int64_t pl = polyr - polyl;
        int64_t t;
        if (bayes116)
          t = (qu[i] + 5 * qmin) / 4;
        else
          t = (int64_t)(qu[i] / 3.0 + (qminp - pl * 2) * poly_adj);
        if (t < (int64_t)qu[i]) nm[i] += (int32_t)(qu[i] - t);
        qminp = qu[i];
        int64_t klo = polyl > i - qhalop ? polyl : i - qhalop;
        int64_t khi = polyr < i + qhalop ? polyr : i + qhalop;
        for (int64_t k = klo; k <= khi; ++k)
          if (qminp > qu[k]) qminp = qu[k];
        if (qmin > qu[i + qhalo]) {
          qmin = qu[i + qhalo];
        } else if (qmin <= qu[i - qhalo]) {
          qmin = 99;
          for (int64_t j = i - qhalo + 1; j <= i + qhalo; ++j)
            if (qmin > qu[j]) qmin = qu[j];
        }
        ++i;
      }
      while (i < qlen) {
        int64_t t;
        if (bayes116)
          t = (qu[i] + 5 * qmin) / 4;
        else
          t = (int64_t)(qu[i] / 3.0 + qminp * poly_adj);
        if (t < (int64_t)qu[i]) nm[i] += (int32_t)(qu[i] - t);
        ++i;
      }
    }

    if (homopoly_fix != 0.0) {
      // _homopoly_qual_fix (bam_consensus.c:943): smooth quals across
      // homopolymer runs, mutating the qual buffer
      int64_t i = 0;
      while (i < qlen) {
        int64_t s = i;
        int base = sq[i];
        while (i + 1 < qlen && sq[i + 1] == base) ++i;
        if (s != i) {
          int64_t j = s, k = i;
          while (j < k) {
            double e = std::pow(10.0, qu[j] / -10.0)
                + std::pow(10.0, qu[k] / -10.0);
            int v = (int)(-cons_fast_log2(e / 2) * 3.0104 + .49);
            qu[j] = (uint8_t)v;
            qu[k] = (uint8_t)v;
            ++j;
            --k;
          }
        }
        ++i;
      }
    }

    {  // poly-X lengths into the top 8 bits
      int64_t i = 0;
      while (i < qlen) {
        int base = sq[i];
        int64_t j = i + 1;
        while (j < qlen && sq[j] == base) ++j;
        int64_t poly = j - i - 1 < 100 ? j - i - 1 : 100;
        for (int64_t k = i; k < j; ++k)
          nm[k] = (int32_t)(((poly > (nm[k] >> 24) ? poly
                                                   : (nm[k] >> 24))
                             << 24)
                            | (nm[k] & ((1 << 24) - 1)));
        i = j;
      }
    }

    const int64_t mlen = md_off[r + 1] - md_off[r];
    if (mlen <= 0) continue;
    const uint8_t* mdp = md + md_off[r];
    const int64_t halo = nm_halo;
    const int64_t c0 = cigar_off[r], c1 = cigar_off[r + 1];
    if (c1 > c0) {
      uint32_t op0 = cigar[c0] & 0xF;
      uint32_t op1 = c1 - c0 > 1 ? cigar[c0 + 1] & 0xF : 0xFFFFFFFF;
      if (op0 == 4 || (op0 == 5 && c1 - c0 > 1 && op1 == 4)) {
        int64_t i = 0;
        while (i < halo && i < qlen) nm[i++] += sc_cost;
        while (i < halo * 2 && i < qlen) nm[i++] += sc_cost >> 1;
      }
      uint32_t opn = cigar[c1 - 1] & 0xF;
      uint32_t opn1 = c1 - c0 > 1 ? cigar[c1 - 2] & 0xF : 0xFFFFFFFF;
      if (opn == 4 || (opn == 5 && c1 - c0 > 1 && opn1 == 4)) {
        int64_t i = qlen - 1;
        while (i >= qlen - halo && i >= 0) nm[i--] += sc_cost;
        while (i >= qlen - halo * 2 && i >= 0) nm[i--] += sc_cost >> 1;
      }
    }
    {  // MD mismatch halos
      int64_t mi = 0, pos = 0;
      while (mi < mlen) {
        uint8_t ch = mdp[mi];
        if (ch >= '0' && ch <= '9') {
          int64_t v = 0;
          while (mi < mlen && mdp[mi] >= '0' && mdp[mi] <= '9') {
            v = v * 10 + (mdp[mi] - '0');
            ++mi;
          }
          pos += v;
          continue;
        }
        if (ch == '^') {
          ++mi;
          while (mi < mlen && !(mdp[mi] >= '0' && mdp[mi] <= '9')) ++mi;
          continue;
        }
        int64_t i = pos - halo * 2 >= 0 ? pos - halo * 2 : 0;
        while (i < pos - halo && i < qlen) nm[i++] += 5;
        while (i < pos + halo && i < qlen) nm[i++] += 10;
        while (i < pos + halo * 2 && i < qlen) nm[i++] += 5;
        ++mi;
      }
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// samtools stats' batched host passes.  Copied from samtools_tpu/native/
// samtpu.cc (:1540-1860), with the CRC32 computed here (zlib's polynomial,
// slice-by-8 tables) in place of the compression library's: crc32(0, buf,
// len) equals Python's zlib.crc32(buf).

namespace stats_detail {

struct Crc32Tables {
  uint32_t t[8][256];
  Crc32Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int k = 1; k < 8; ++k)
        t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

const Crc32Tables& crc_tables() {
  static const Crc32Tables tables;
  return tables;
}

// zlib's crc32(crc, buf, len): the reflected CRC-32 of IEEE 802.3
uint32_t crc32(uint32_t crc, const uint8_t* p, size_t n) {
  const Crc32Tables& T = crc_tables();
  uint32_t c = ~crc;
  while (n && ((uintptr_t)p & 7)) {
    c = T.t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
    --n;
  }
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= c;  // little-endian byte order, as on x86-64 and aarch64
    c = T.t[7][lo & 0xFF] ^ T.t[6][(lo >> 8) & 0xFF] ^
        T.t[5][(lo >> 16) & 0xFF] ^ T.t[4][lo >> 24] ^
        T.t[3][hi & 0xFF] ^ T.t[2][(hi >> 8) & 0xFF] ^
        T.t[1][(hi >> 16) & 0xFF] ^ T.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = T.t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return ~c;
}

struct CovGcd {
  int64_t* state;
  int32_t* rbuf;
  int64_t size;
  int64_t* cov;
  int64_t ncov, cov_min, cov_max, cov_step;

  inline int64_t cov_idx(int64_t v) const {
    if (v < cov_min) return 0;
    if (v > cov_max) return ncov - 1;
    return 1 + (v - cov_min) / cov_step;
  }
  inline void flush_span(int64_t a, int64_t b) {
    for (int64_t i = a; i < b; ++i) {
      if (rbuf[i]) {
        ++cov[cov_idx(rbuf[i])];
        rbuf[i] = 0;
      }
    }
  }
  // round_buffer_flush (stats.c:329); returns false on the ascending-order
  // error (payload in state[10..11]).
  inline bool flush(int64_t pos) {
    int64_t& start = state[0];
    int64_t& rpos = state[1];
    if (pos == rpos) return true;
    int64_t new_pos = pos;
    if (pos == -1 || pos - rpos >= size) pos = rpos + size - 1;
    if (pos < rpos) {
      state[10] = pos;
      state[11] = rpos;
      return false;
    }
    int64_t ifrom = start;
    int64_t ito = (start + (pos - 1 - rpos) % size) % size;
    if (ifrom > ito) {
      flush_span(ifrom, size);
      ifrom = 0;
    }
    flush_span(ifrom, ito + 1);
    start = new_pos == -1 ? 0 : (start + (pos - rpos) % size) % size;
    rpos = new_pos;
    return true;
  }
  // round_buffer_insert_read (stats.c:372); 0 ok, else error code.
  inline int64_t insert(int64_t frm, int64_t to) {
    int64_t start = state[0], rpos = state[1];
    if (to - frm > size) {
      state[10] = to - frm;
      state[11] = size;
      return -1;
    }
    if (frm < rpos) {
      state[10] = frm;
      state[11] = rpos;
      return -3;
    }
    int64_t ifrom = (start + (frm - rpos) % size) % size;
    int64_t ito = (start + (to - rpos) % size) % size;
    if (ifrom > ito) {
      for (int64_t i = ifrom; i < size; ++i) ++rbuf[i];
      ifrom = 0;
    }
    for (int64_t i = ifrom; i < ito; ++i) ++rbuf[i];
    return 0;
  }
};

}  // namespace stats_detail

extern "C" {

// Sum of per-record CRC32s (names / packed seq / qual), mod 2^32.
// idx selects records; seq holds one nt16 code PER BASE (unpacked) and is
// packed 2-per-byte here exactly like the BAM encoding before the CRC
// (update_checksum computes the CRC over the packed representation).
// out[0]+=names, out[1]+=reads, out[2]+=quals.  qual/seq share offsets.
// Records with zero-length seq contribute the name CRC only.
int64_t samtpu_stats_crc32_batch(
    const uint8_t* qname, const int64_t* qname_off, const uint8_t* seq,
    const uint8_t* qual, const int64_t* seq_off, const int64_t* idx,
    int64_t nidx, uint32_t* out) {
  uint32_t names = 0, reads = 0, quals = 0;
  std::vector<uint8_t> packed;
  for (int64_t k = 0; k < nidx; ++k) {
    int64_t i = idx[k];
    names += stats_detail::crc32(0, qname + qname_off[i],
                                 (size_t)(qname_off[i + 1] - qname_off[i]));
    int64_t s0 = seq_off[i], s1 = seq_off[i + 1];
    int64_t len = s1 - s0;
    if (!len) continue;
    packed.resize((size_t)((len + 1) / 2));
    for (int64_t j = 0; j + 1 < len; j += 2)
      packed[(size_t)(j / 2)] =
          (uint8_t)((seq[s0 + j] << 4) | seq[s0 + j + 1]);
    if (len & 1) packed[(size_t)(len / 2)] = (uint8_t)(seq[s1 - 1] << 4);
    reads += stats_detail::crc32(0, packed.data(), packed.size());
    quals += stats_detail::crc32(0, qual + s0, (size_t)len);
  }
  out[0] += names;
  out[1] += reads;
  out[2] += quals;
  return nidx;
}

// Find one aux tag per selected record (SAM spec 4.2.4 walk).  For record
// idx[k]: out_off[k] = absolute offset of the VALUE byte (past the type
// char) in aux, out_type[k] = type char, or out_off[k] = -1 if absent or
// the aux block is malformed.
int64_t samtpu_aux_find_batch(
    const uint8_t* aux, const int64_t* aux_off, const int64_t* idx,
    int64_t nidx, uint8_t tag0, uint8_t tag1, int64_t* out_off,
    uint8_t* out_type) {
  for (int64_t k = 0; k < nidx; ++k) {
    int64_t i = idx[k];
    int64_t p = aux_off[i], end = aux_off[i + 1];
    out_off[k] = -1;
    out_type[k] = 0;
    while (p + 3 <= end) {
      uint8_t t0 = aux[p], t1 = aux[p + 1], tc = aux[p + 2];
      int64_t v = p + 3;
      int64_t sz;
      switch (tc) {
        case 'A': case 'c': case 'C': sz = 1; break;
        case 's': case 'S': sz = 2; break;
        case 'i': case 'I': case 'f': sz = 4; break;
        case 'd': sz = 8; break;
        case 'Z': case 'H': {
          int64_t q = v;
          while (q < end && aux[q] != 0) ++q;
          sz = q - v + 1;
          break;
        }
        case 'B': {
          if (v + 5 > end) { p = end + 1; continue; }
          uint8_t sub = aux[v];
          uint32_t cnt;
          std::memcpy(&cnt, aux + v + 1, 4);
          int64_t es;
          switch (sub) {
            case 'c': case 'C': es = 1; break;
            case 's': case 'S': es = 2; break;
            case 'i': case 'I': case 'f': es = 4; break;
            default: es = 0; break;
          }
          if (!es) { p = end + 1; continue; }
          sz = 5 + (int64_t)cnt * es;
          break;
        }
        default: p = end + 1; continue;
      }
      if (t0 == tag0 && t1 == tag1) {
        out_off[k] = v;
        out_type[k] = tc;
        break;
      }
      p = v + sz;
    }
  }
  return nidx;
}

// Sequential residue of collect_stats' sorted block (stats.c:1395-1500):
// is_sorted tracking, tid-change flush, GC-depth bins, coverage round
// buffer.  Vectorized feeders supply, per record: active[i] (the record
// reaches the sorted block), readlen[i] (seq len + deletions), gc_term[i]
// (float gc_count/seq_len), and the absolute [beg,end) spans of its
// M/=/X ops (span_beg/span_end flat, span_off per record).
//
// state[16]: 0 rbuf_start, 1 rbuf_pos, 2 tid, 3 gcd_pos, 4 igcd,
//   5 is_sorted, 6 prev_pos, 7 resume_i, 8 inc_done_i, 9 pause_i(out),
//   10/11 payload(out), 12 unsorted_at, 13 rseq_pos, 14 nrseq_buf.
// Returns 0 done; 1 fai ref/bin pause at state[9] (Python runs the
// inc_ref/inc_gcd branch of stats.c:1404 and resumes with
// inc_done_i = pause_i); 3 gcd arrays full (grow + resume); -1 read-too-
// big; -3 unsorted insert; -4 flush order error (payloads state[10..11]).
int64_t samtpu_stats_cov_gcd(
    int64_t n, int64_t* state, const int32_t* tid, const int64_t* pos,
    const int64_t* readlen, const uint8_t* active, const float* gc_term,
    const int64_t* span_off, const int64_t* span_beg,
    const int64_t* span_end, int fai_mode, int64_t gcd_bin_size,
    int32_t* rbuf, int64_t rbuf_size, int64_t* cov, int64_t ncov,
    int64_t cov_min, int64_t cov_max, int64_t cov_step, float* gcd_gc,
    int64_t* gcd_depth, int64_t gcd_cap) {
  stats_detail::CovGcd rb{state,    rbuf,    rbuf_size, cov,
                          ncov,     cov_min, cov_max,   cov_step};
  for (int64_t i = state[7]; i < n; ++i) {
    if (!active[i]) continue;
    int64_t rtid = tid[i], rpos = pos[i];
    // is_sorted check + pos update (stats.c:1390)
    if (state[2] == rtid && rpos < state[6]) {
      if (state[5]) {
        state[5] = 0;
        state[12] = i;
      }
    }
    state[6] = rpos;
    if (!state[5]) continue;
    // tid-change flush (stats.c:1396)
    if (state[2] == -1 || state[2] != rtid) {
      if (!rb.flush(-1)) {
        state[9] = i;
        return -4;
      }
    }
    if (fai_mode) {
      if (state[8] != i) {
        // pause for Python whenever the inc_ref/inc_gcd branch would run
        int64_t rseq_pos = state[13], nrseq = state[14];
        bool inc = (rseq_pos == -1 || state[2] != rtid ||
                    rseq_pos + nrseq < rpos + readlen[i]) ||
                   (state[3] + gcd_bin_size < rpos + readlen[i]);
        if (inc) {
          state[7] = i;
          state[9] = i;
          return 1;
        }
      }
    } else if (state[3] == -1 || state[2] != rtid ||
               rpos - state[3] > gcd_bin_size) {
      if (state[4] + 1 >= gcd_cap) {
        state[7] = i;
        state[9] = i;
        return 3;
      }
      state[2] = rtid;
      state[3] = rpos;
      ++state[4];
    }
    gcd_depth[state[4]] += 1;
    if (!fai_mode) gcd_gc[state[4]] += gc_term[i];
    // coverage round buffer (stats.c:1453)
    if (!rb.flush(rpos)) {
      state[9] = i;
      return -4;
    }
    for (int64_t s = span_off[i]; s < span_off[i + 1]; ++s) {
      int64_t rc = rb.insert(span_beg[s], span_end[s]);
      if (rc) {
        state[9] = i;
        return rc;
      }
    }
  }
  state[7] = n;
  return 0;
}

// Per-base histogram pass for stats' original-read accumulators
// (collect_orig_read_stats, stats.c:917): first/last-fragment quality
// matrices, ACGT-per-cycle, reverse-complement base matrix, per-read GC
// counts and quality sums.  One pass over the flat seq / qual columns;
// threads split the read range with private histograms merged at the
// end.  The host branch (SAMTPU_DEVICE=0) of K12 (csrc/stats_hists.cu),
// and the oracle it is held to.
int64_t samtpu_stats_orig_hists(
    const uint8_t* seq, const uint8_t* qual, const int64_t* seq_off,
    const int64_t* oidx, int64_t no, const uint8_t* order,
    const uint8_t* rev, int64_t nbases, int64_t qrows, int64_t* q1,
    int64_t* q2, int64_t* a1, int64_t* a2, int64_t* ar, int64_t* gc_out,
    int64_t* qsum_out, int64_t* maxq_io, int nthreads) {
  static const uint8_t kCol[16] = {5, 0, 1, 5, 2, 5, 5, 5,
                                   3, 5, 5, 5, 5, 5, 5, 4};
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 8) nthreads = 8;
  struct Local {
    std::vector<int64_t> q1, q2, a1, a2, ar;
    int64_t maxq = 0;
  };
  std::vector<Local> locals((size_t)nthreads);
  std::vector<std::thread> threads;
  int64_t chunk = (no + nthreads - 1) / nthreads;
  auto work = [&](int t) {
    Local& L = locals[(size_t)t];
    L.q1.assign((size_t)(qrows * 257), 0);
    L.q2.assign((size_t)(qrows * 257), 0);
    L.a1.assign((size_t)(nbases * 6), 0);
    L.a2.assign((size_t)(nbases * 6), 0);
    L.ar.assign((size_t)(nbases * 6), 0);
    int64_t lo = t * chunk, hi = lo + chunk;
    if (hi > no) hi = no;
    for (int64_t k = lo; k < hi; ++k) {
      int64_t i = oidx[k];
      int64_t s0 = seq_off[i], len = seq_off[i + 1] - s0;
      int ord = order[k];
      bool rv = rev[k] != 0;
      int64_t* qh = ord == 1 ? L.q1.data() : ord == 2 ? L.q2.data() : nullptr;
      int64_t* ah = ord == 1 ? L.a1.data() : ord == 2 ? L.a2.data() : nullptr;
      int64_t gc = 0, qs = 0;
      for (int64_t j = 0; j < len; ++j) {
        uint8_t b = seq[s0 + j];
        uint8_t q = qual[s0 + j];
        uint8_t c = kCol[b & 0xF];
        gc += (b == 2 || b == 4);
        int64_t cyc = rv ? len - 1 - j : j;
        if (ah) {
          ah[cyc * 6 + c] += 1;
          if (c < 4) L.ar.data()[cyc * 6 + (rv ? 3 - c : c)] += 1;
          qh[cyc * 257 + q] += 1;
          qs += q;
          if (q > L.maxq) L.maxq = q;
        }
      }
      gc_out[k] = gc;
      qsum_out[k] = qs;
    }
  };
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
  for (auto& L : locals) {
    for (int64_t x = 0; x < qrows * 257; ++x) {
      q1[x] += L.q1[(size_t)x];
      q2[x] += L.q2[(size_t)x];
    }
    for (int64_t x = 0; x < nbases * 6; ++x) {
      a1[x] += L.a1[(size_t)x];
      a2[x] += L.a2[(size_t)x];
      ar[x] += L.ar[(size_t)x];
    }
    if (L.maxq > *maxq_io) *maxq_io = L.maxq;
  }
  return no;
}

}  // extern "C"


// ---------------------------------------------------------------------------
// SAM text formatting: columnar batch -> one text buffer.
//
// The same bytes as io/sam_text.py's format_record (htslib's sam_format1,
// %g floats included), for a batch of records at once.  Returns the record
// count and a malloc'd buffer in *out (freed by samtpu_buf_free); a
// negative return is a malformed record, which the caller formats through
// the Python path so that its errors are raised.
extern "C" int64_t samtpu_sam_format(
    int64_t nidx, const int64_t* idx, const int32_t* tid,
    const int64_t* pos, const uint8_t* mapq, const uint16_t* flag,
    const int32_t* mtid, const int64_t* mpos, const int64_t* tlen,
    const uint8_t* qname, const int64_t* qname_off, const uint32_t* cigar,
    const int64_t* cigar_off, const uint8_t* seq, const int64_t* seq_off,
    const uint8_t* qual, const uint8_t* aux, const int64_t* aux_off,
    const uint8_t* names, const int64_t* names_off, int64_t n_refs,
    uint8_t** out, int64_t* out_len) {
  static const char kSeq[] = "=ACMGRSVTWYHKDBN";
  static const char kCig[] = "MIDNSHP=XB??????";
  std::string s;
  s.reserve((size_t)(nidx * 192));
  char tmp[64];

  auto put_name = [&](int32_t t) {
    if (t < 0 || t >= n_refs) {
      s += '*';
    } else {
      s.append((const char*)names + names_off[t],
               (size_t)(names_off[t + 1] - names_off[t]));
    }
  };

  for (int64_t k = 0; k < nidx; ++k) {
    int64_t i = idx[k];
    s.append((const char*)qname + qname_off[i],
             (size_t)(qname_off[i + 1] - qname_off[i]));
    s += '\t';
    s += std::to_string((unsigned)flag[i]);
    s += '\t';
    put_name(tid[i]);
    s += '\t';
    s += std::to_string(pos[i] + 1);
    s += '\t';
    s += std::to_string((unsigned)mapq[i]);
    s += '\t';
    int64_t c0 = cigar_off[i], c1 = cigar_off[i + 1];
    if (c0 == c1) {
      s += '*';
    } else {
      for (int64_t c = c0; c < c1; ++c) {
        s += std::to_string(cigar[c] >> 4);
        s += kCig[cigar[c] & 0xF];
      }
    }
    s += '\t';
    if (mtid[i] < 0) {
      s += '*';
    } else if (mtid[i] == tid[i]) {
      s += '=';
    } else {
      put_name(mtid[i]);
    }
    s += '\t';
    s += std::to_string(mpos[i] + 1);
    s += '\t';
    s += std::to_string(tlen[i]);
    s += '\t';
    int64_t s0 = seq_off[i], s1 = seq_off[i + 1];
    if (s0 == s1) {
      s += '*';
    } else {
      for (int64_t j = s0; j < s1; ++j) s += kSeq[seq[j] & 0xF];
    }
    s += '\t';
    bool allff = true;
    for (int64_t j = s0; j < s1; ++j) {
      if (qual[j] != 0xFF) {
        allff = false;
        break;
      }
    }
    if (s0 == s1 || allff) {
      s += '*';
    } else {
      for (int64_t j = s0; j < s1; ++j) s += (char)(qual[j] + 33);
    }
    // aux fields
    int64_t p = aux_off[i], end = aux_off[i + 1];
    while (p + 3 <= end) {
      char t0 = (char)aux[p], t1 = (char)aux[p + 1];
      uint8_t tc = aux[p + 2];
      int64_t v = p + 3;
      s += '\t';
      s += t0;
      s += t1;
      s += ':';
      switch (tc) {
        case 'A':
          if (v >= end) return -(k + 1);
          s += "A:";
          s += (char)aux[v];
          p = v + 1;
          break;
        case 'c': case 'C': case 's': case 'S': case 'i': case 'I': {
          int64_t w = (tc == 'c' || tc == 'C') ? 1
                      : (tc == 's' || tc == 'S') ? 2 : 4;
          if (v + w > end) return -(k + 1);
          int64_t val = 0;
          uint32_t uv = 0;
          for (int64_t bbi = 0; bbi < w; ++bbi)
            uv |= (uint32_t)aux[v + bbi] << (8 * bbi);
          if (tc == 'c') val = (int8_t)uv;
          else if (tc == 's') val = (int16_t)uv;
          else if (tc == 'i') val = (int32_t)uv;
          else val = uv;
          s += "i:";
          s += std::to_string(val);
          p = v + w;
          break;
        }
        case 'f': case 'd': {
          int64_t w = tc == 'f' ? 4 : 8;
          if (v + w > end) return -(k + 1);
          double dv;
          if (tc == 'f') {
            float fv;
            std::memcpy(&fv, aux + v, 4);
            dv = fv;
          } else {
            std::memcpy(&dv, aux + v, 8);
          }
          snprintf(tmp, sizeof tmp, "%g", dv);
          s += tc;
          s += ':';
          s += tmp;
          p = v + w;
          break;
        }
        case 'Z': case 'H': {
          int64_t q = v;
          while (q < end && aux[q]) ++q;
          s += (char)tc;
          s += ':';
          s.append((const char*)aux + v, (size_t)(q - v));
          p = q + 1;
          break;
        }
        case 'B': {
          if (v + 5 > end) return -(k + 1);
          uint8_t sub = aux[v];
          uint32_t cnt;
          std::memcpy(&cnt, aux + v + 1, 4);
          int64_t es;
          switch (sub) {
            case 'c': case 'C': es = 1; break;
            case 's': case 'S': es = 2; break;
            case 'i': case 'I': case 'f': es = 4; break;
            default: return -(k + 1);
          }
          int64_t body = v + 5;
          if (body + (int64_t)cnt * es > end) return -(k + 1);
          s += "B:";
          s += (char)sub;
          for (uint32_t e = 0; e < cnt; ++e) {
            s += ',';
            const uint8_t* bp = aux + body + (int64_t)e * es;
            if (sub == 'f') {
              float fv;
              std::memcpy(&fv, bp, 4);
              snprintf(tmp, sizeof tmp, "%g", (double)fv);
              s += tmp;
            } else {
              uint32_t uv = 0;
              for (int64_t bbi = 0; bbi < es; ++bbi)
                uv |= (uint32_t)bp[bbi] << (8 * bbi);
              int64_t val;
              if (sub == 'c') val = (int8_t)uv;
              else if (sub == 's') val = (int16_t)uv;
              else if (sub == 'i') val = (int32_t)uv;
              else val = uv;
              s += std::to_string(val);
            }
          }
          p = body + (int64_t)cnt * es;
          break;
        }
        default:
          return -(k + 1);
      }
    }
    if (p != end) return -(k + 1);
    s += '\n';
  }
  uint8_t* buf = (uint8_t*)malloc(s.size() ? s.size() : 1);
  if (!buf) return -1000000000;
  std::memcpy(buf, s.data(), s.size());
  *out = buf;
  *out_len = (int64_t)s.size();
  return nidx;
}
