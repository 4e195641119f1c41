/* Dictionary-trie string_feature plugin: ux-class enumeration and a
 * mecab-class Viterbi segmenter in one shared object.
 *
 * Fills the role of the reference's shipped tokenizer plugins
 * (its plugin/src/fv_converter/ux_splitter.cpp — trie
 * common-prefix enumeration of dictionary words; mecab_splitter.cpp —
 * lattice-based morphological segmentation), re-implemented from the
 * algorithms, not the code: a first-child/next-sibling byte trie plus a
 * min-cost Viterbi walk with per-word costs and an unknown-character
 * penalty (the connection-matrix-free core of the mecab model).
 *
 * Conventions (consumed by jubatus_tpu_torch/fv/plugin.py _CSplitter):
 *   int <fn>_init(const char* dict_path)  -> dictionary handle (>= 0)
 *   int <fn>(int handle, const char* text,
 *            int* begins, int* lengths, int max_tokens)
 * The handle keeps multiple dictionaries independent within one loaded
 * library (the reference gets this from one C++ object per `create`).
 *
 * Dictionary file: one UTF-8 word per line, optionally
 * "word\tcost[\tleft_id\tright_id]" (lower cost = preferred; default
 * 4000; context ids index the connection matrix and require one).
 * Connection matrix (mecab matrix.def role): optional "<dict>.matrix"
 * file — first line "n_right n_left", then "right left cost" rows
 * (unlisted pairs cost 0).  Build:
 *   jubatus_tpu_torch/native/plugins/__init__.py, at first use
 */

#include <limits.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
  unsigned char ch;
  int first_child; /* node index, -1 = none */
  int next_sib;    /* node index, -1 = none */
  int word_cost;   /* INT_MAX = not a word end */
  short left_id;   /* connection context ids (mecab model); 0 = default */
  short right_id;
} Node;

typedef struct {
  Node* nodes;
  int n_nodes, cap;
  /* connection cost matrix (mecab matrix.def role): conn[r * n_left + l]
   * = cost of joining a word with right-context r to a word with
   * left-context l.  Loaded from "<dict_path>.matrix" when present;
   * absent = 1x1 zero matrix (connection-free Viterbi, the pre-matrix
   * behavior). */
  int* conn;
  int n_right, n_left;
} Trie;

#define MAX_DICTS 64
static Trie g_dicts[MAX_DICTS];
static int g_n_dicts = 0;

static int new_node(Trie* t, unsigned char ch) {
  if (t->n_nodes == t->cap) {
    int cap = t->cap ? t->cap * 2 : 256;
    Node* nn = (Node*)realloc(t->nodes, (size_t)cap * sizeof(Node));
    if (!nn) return -1;
    t->nodes = nn;
    t->cap = cap;
  }
  Node* n = &t->nodes[t->n_nodes];
  n->ch = ch;
  n->first_child = -1;
  n->next_sib = -1;
  n->word_cost = INT_MAX;
  n->left_id = 0;
  n->right_id = 0;
  return t->n_nodes++;
}

/* child of `node` on byte `ch`; -1 when absent (create=0) */
static int child(Trie* t, int node, unsigned char ch, int create) {
  int c = t->nodes[node].first_child;
  while (c >= 0) {
    if (t->nodes[c].ch == ch) return c;
    c = t->nodes[c].next_sib;
  }
  if (!create) return -1;
  c = new_node(t, ch);
  if (c < 0) return -1;
  t->nodes[c].next_sib = t->nodes[node].first_child;
  t->nodes[node].first_child = c;
  return c;
}

#define DEFAULT_WORD_COST 4000
#define UNKNOWN_CHAR_COST 10000

/* release a partially built trie so a failed init leaves no allocation
 * behind (the slot would otherwise be memset on the next init, leaking
 * nodes in a long-lived server process) */
static int init_fail(Trie* t, FILE* f) {
  free(t->nodes);
  free(t->conn);
  memset(t, 0, sizeof(*t));
  fclose(f);
  return -1;
}

#define MAX_CONN_IDS 4096

/* "<dict>.matrix": first line "n_right n_left", then "right left cost"
 * rows (unlisted pairs cost 0).  Returns 0 on success or no file, -1 on
 * a malformed/oversized file (refusing beats silently ignoring costs). */
static int load_matrix(Trie* t, const char* dict_path) {
  char path[4096];
  if (snprintf(path, sizeof path, "%s.matrix", dict_path) >=
      (int)sizeof path)
    return -1;
  FILE* f = fopen(path, "rb");
  if (!f) {
    t->n_right = 1;
    t->n_left = 1;
    t->conn = (int*)calloc(1, sizeof(int));
    return t->conn ? 0 : -1;
  }
  int nr = 0, nl = 0;
  if (fscanf(f, "%d %d", &nr, &nl) != 2 || nr <= 0 || nl <= 0 ||
      nr > MAX_CONN_IDS || nl > MAX_CONN_IDS ||
      (long)nr * nl > 1 << 22) {
    fclose(f);
    return -1;
  }
  int* conn = (int*)calloc((size_t)nr * nl, sizeof(int));
  if (!conn) {
    fclose(f);
    return -1;
  }
  int r, l, cost;
  while (fscanf(f, "%d %d %d", &r, &l, &cost) == 3) {
    if (r < 0 || r >= nr || l < 0 || l >= nl) {
      free(conn);
      fclose(f);
      return -1;
    }
    conn[r * nl + l] = cost;
  }
  /* anything left after the last full row is a malformed/truncated
   * file — refusing beats quietly loading half a matrix */
  int ch;
  while ((ch = fgetc(f)) != EOF) {
    if (ch != ' ' && ch != '\t' && ch != '\r' && ch != '\n') {
      free(conn);
      fclose(f);
      return -1;
    }
  }
  fclose(f);
  t->conn = conn;
  t->n_right = nr;
  t->n_left = nl;
  return 0;
}

int split_init(const char* dict_path) {
  if (g_n_dicts >= MAX_DICTS) return -1;
  FILE* f = fopen(dict_path, "rb");
  if (!f) return -1;
  Trie* t = &g_dicts[g_n_dicts];
  memset(t, 0, sizeof(*t));
  if (new_node(t, 0) != 0) { /* root = node 0 */
    return init_fail(t, f);
  }
  if (load_matrix(t, dict_path) != 0) return init_fail(t, f);
  char line[4096];
  while (fgets(line, sizeof line, f)) {
    size_t len = strcspn(line, "\r\n");
    line[len] = '\0';
    /* "word[\tcost[\tleft_id\tright_id]]" */
    int cost = DEFAULT_WORD_COST;
    long lid = 0, rid = 0;
    char* tab = strchr(line, '\t');
    if (tab) {
      *tab = '\0';
      cost = atoi(tab + 1);
      char* tab2 = strchr(tab + 1, '\t');
      if (tab2) {
        lid = atol(tab2 + 1);
        char* tab3 = strchr(tab2 + 1, '\t');
        if (tab3) rid = atol(tab3 + 1);
      }
    }
    if (lid < 0 || lid >= t->n_left || rid < 0 || rid >= t->n_right)
      return init_fail(t, f); /* id outside the loaded matrix */
    len = strlen(line);
    if (len == 0) continue;
    int node = 0;
    for (size_t i = 0; i < len; i++) {
      node = child(t, node, (unsigned char)line[i], 1);
      if (node < 0) return init_fail(t, f);
    }
    if (cost < t->nodes[node].word_cost) {
      t->nodes[node].word_cost = cost;
      t->nodes[node].left_id = (short)lid;
      t->nodes[node].right_id = (short)rid;
    }
  }
  fclose(f);
  return g_n_dicts++;
}

/* ux-class: enumerate EVERY dictionary word occurring at every byte
 * position (common-prefix search per start offset). */
int split(int handle, const char* text, int* begins, int* lengths,
          int max_tokens) {
  if (handle < 0 || handle >= g_n_dicts) return -1;
  Trie* t = &g_dicts[handle];
  int len = (int)strlen(text);
  int n = 0;
  for (int i = 0; i < len; i++) {
    int node = 0;
    for (int j = i; j < len; j++) {
      node = child(t, node, (unsigned char)text[j], 0);
      if (node < 0) break;
      if (t->nodes[node].word_cost != INT_MAX) {
        if (n >= max_tokens) return n;
        begins[n] = i;
        lengths[n] = j - i + 1;
        n++;
      }
    }
  }
  return n;
}

int viterbi_split_init(const char* dict_path) {
  return split_init(dict_path);
}

static int utf8_char_len(unsigned char b) {
  if (b < 0x80) return 1;
  if ((b & 0xE0) == 0xC0) return 2;
  if ((b & 0xF0) == 0xE0) return 3;
  if ((b & 0xF8) == 0xF0) return 4;
  return 1; /* continuation/invalid byte: step one */
}

/* mecab-class: min-cost FULL segmentation of the text over the
 * (byte position, right-context-id) lattice.  Edge cost of a word w at
 * position i after context r: conn[r][left_id(w)] + word_cost(w) —
 * the mecab path-cost model (word costs + connection matrix).  BOS and
 * EOS use context id 0, as do the one-character unknown edges
 * (UNKNOWN_CHAR_COST); adjacent unknown characters merge into one token
 * on emit (the unknown-word grouping, without per-charclass rules).
 * With no matrix file the lattice degenerates to the single-context
 * connection-free walk. */
int viterbi_split(int handle, const char* text, int* begins, int* lengths,
                  int max_tokens) {
  if (handle < 0 || handle >= g_n_dicts) return -1;
  Trie* t = &g_dicts[handle];
  int len = (int)strlen(text);
  if (len == 0) return 0;
  int R = t->n_right, NL = t->n_left;
  if ((long)(len + 1) * R > (1L << 24)) return -1; /* lattice too large */
  size_t cells = (size_t)(len + 1) * (size_t)R;
  long* best = (long*)malloc(cells * sizeof(long));
  int* bpos = (int*)malloc(cells * sizeof(int));
  short* bctx = (short*)malloc(cells * sizeof(short));
  char* bword = (char*)malloc(cells);
  /* per-position word list: end offset + cost + ids for each dict word
   * starting at i (collected once, reused for every incoming context) */
  int* we = (int*)malloc((size_t)(len > 0 ? len : 1) * sizeof(int));
  int* wc = (int*)malloc((size_t)(len > 0 ? len : 1) * sizeof(int));
  short* wl = (short*)malloc((size_t)(len > 0 ? len : 1) * sizeof(short));
  short* wr = (short*)malloc((size_t)(len > 0 ? len : 1) * sizeof(short));
  /* backtrack scratch: up to len spans BEFORE the merge stage — the
   * caller's begins/lengths only hold max_tokens, so spans must never
   * be written there unbounded (a >max_tokens no-match text would
   * otherwise overflow the caller's buffers) */
  int* sb = (int*)malloc((size_t)(len > 0 ? len : 1) * sizeof(int));
  int* sl = (int*)malloc((size_t)(len > 0 ? len : 1) * sizeof(int));
  if (!best || !bpos || !bctx || !bword || !we || !wc || !wl || !wr ||
      !sb || !sl) {
    free(best); free(bpos); free(bctx); free(bword);
    free(we); free(wc); free(wl); free(wr); free(sb); free(sl);
    return -1;
  }
  for (size_t k = 0; k < cells; k++) best[k] = LONG_MAX;
  best[0] = 0; /* BOS: position 0, context 0 */
  for (int i = 0; i < len; i++) {
    /* words starting at i (one trie walk, shared across contexts) */
    int nw = 0;
    int node = 0;
    for (int j = i; j < len; j++) {
      node = child(t, node, (unsigned char)text[j], 0);
      if (node < 0) break;
      if (t->nodes[node].word_cost != INT_MAX) {
        we[nw] = j + 1;
        wc[nw] = t->nodes[node].word_cost;
        wl[nw] = t->nodes[node].left_id;
        wr[nw] = t->nodes[node].right_id;
        nw++;
      }
    }
    int u = utf8_char_len((unsigned char)text[i]);
    if (i + u > len) u = len - i;
    for (int r = 0; r < R; r++) {
      long base = best[(size_t)i * R + r];
      if (base == LONG_MAX) continue;
      const int* conn_r = t->conn + (size_t)r * NL;
      for (int k = 0; k < nw; k++) {
        long cand = base + conn_r[wl[k]] + wc[k];
        size_t cell = (size_t)we[k] * R + wr[k];
        if (cand < best[cell]) {
          best[cell] = cand;
          bpos[cell] = i;
          bctx[cell] = (short)r;
          bword[cell] = 1;
        }
      }
      /* unknown edge: context ids 0 */
      long cand = base + conn_r[0] + UNKNOWN_CHAR_COST;
      size_t cell = (size_t)(i + u) * R; /* right context 0 */
      if (cand < best[cell]) {
        best[cell] = cand;
        bpos[cell] = i;
        bctx[cell] = (short)r;
        bword[cell] = 0;
      }
    }
  }
  /* EOS (left context 0): pick the best final right context */
  int end_r = 0;
  long end_cost = LONG_MAX;
  for (int r = 0; r < R; r++) {
    long b = best[(size_t)len * R + r];
    if (b == LONG_MAX) continue;
    long cand = b + t->conn[(size_t)r * NL];
    if (cand < end_cost) {
      end_cost = cand;
      end_r = r;
    }
  }
  if (end_cost == LONG_MAX) { /* unreachable in practice: unknown edges
                               * always connect — defensive */
    free(best); free(bpos); free(bctx); free(bword);
    free(we); free(wc); free(wl); free(wr); free(sb); free(sl);
    return 0;
  }
  /* backtrack into the scratch (spans come out reversed) */
  int n = 0;
  int pos = len;
  int ctx = end_r;
  while (pos > 0 && n < len) {
    size_t cell = (size_t)pos * R + ctx;
    int prev = bpos[cell];
    sb[n] = prev;
    sl[n] = pos - prev;
    /* sign marks unknown spans for the merge stage */
    if (!bword[cell]) sl[n] = -sl[n];
    ctx = bctx[cell];
    n++;
    pos = prev;
  }
  /* reverse in place */
  for (int a = 0, b = n - 1; a < b; a++, b--) {
    int tb = sb[a], tl = sl[a];
    sb[a] = sb[b]; sl[a] = sl[b];
    sb[b] = tb; sl[b] = tl;
  }
  /* merge adjacent unknown spans into the CALLER's bounded buffers */
  int out = 0;
  for (int a = 0; a < n; a++) {
    int unk = sl[a] < 0;
    int l = unk ? -sl[a] : sl[a];
    if (unk && out > 0 && lengths[out - 1] < 0 &&
        begins[out - 1] - lengths[out - 1] == sb[a]) {
      lengths[out - 1] -= l; /* extend previous unknown (negative) */
    } else {
      if (out >= max_tokens) break;
      begins[out] = sb[a];
      lengths[out] = unk ? -l : l;
      out++;
    }
  }
  for (int a = 0; a < out; a++)
    if (lengths[a] < 0) lengths[a] = -lengths[a];
  free(best);
  free(bpos);
  free(bctx);
  free(bword);
  free(we);
  free(wc);
  free(wl);
  free(wr);
  free(sb);
  free(sl);
  return out;
}
