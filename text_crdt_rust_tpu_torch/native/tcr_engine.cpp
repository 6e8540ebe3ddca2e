// tcr_engine.cpp — native host-side list-CRDT document engine.
//
// C++ rebuild of the reference ListCRDT (upstream `src/list/doc.rs`)
// with a different core container: instead of the reference's pointer-based
// RLE B-tree with subtree sums (`src/range_tree/`), the document body is an
// order-statistic *treap of RLE YjsSpan runs* with two augmentations per
// subtree — raw item count and live (content) count — which gives the same
// O(log n) position<->item conversions (`README.md:20-26`) with split/merge
// instead of node-splitting B-tree mutations (`range_tree/mutations.rs`).
//
// Semantics preserved from the reference:
//  * YjsSpan origin fix-ups on split (`list/span.rs:33-45,68-85`) and the
//    append merge predicate (`span.rs:47-53`);
//  * tombstones are len sign-flips (`span.rs:110-119`);
//  * Yjs/YATA integrate with name tiebreak (`doc.rs:167-234`), including the
//    scan_start pinning fix documented in models/oracle.py;
//  * deletes keyed by the delete op's order (`list/mod.rs:82-84`), remote
//    delete targets walked in seq space (see models/oracle.py rationale),
//    double-delete interval increments (`double_delete.rs:41-106`);
//  * frontier advance + txn shadow (`doc.rs:34-48`, `:350-374`).
//
// Exposed as a C ABI for ctypes (models/native.py).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>
#include <map>
#include <algorithm>

typedef uint32_t u32;
typedef int32_t i32;
typedef uint64_t u64;

static const u32 ROOT_ORDER = 0xFFFFFFFFu;
static const u32 AGENT_ROOT = 0xFFFFFFFFu;
static const int NIL = -1;

// ---------------------------------------------------------------- treap ----

struct Node {
    u32 order;        // first order of the span
    u32 ol;           // origin_left of the first item (`span.rs:9-13`)
    u32 orr;          // origin_right shared by all items (`span.rs:15-18`)
    i32 len;          // signed; negative = deleted (`span.rs:20`)
    u32 pri;          // treap priority
    int l, r, p;      // children + parent
    u32 sum_raw;      // subtree sum of |len|
    u32 sum_content;  // subtree sum of max(len, 0)
};

static inline u32 uabs(i32 x) { return (u32)(x < 0 ? -x : x); }

struct Rng {
    u64 s;
    explicit Rng(u64 seed) : s(seed) {}
    u32 next() {
        // xorshift64* — deterministic priorities.
        s ^= s >> 12; s ^= s << 25; s ^= s >> 27;
        return (u32)((s * 0x2545F4914F6CDD1DULL) >> 32);
    }
};

// ------------------------------------------------------------ RLE logs ----

struct CwoEntry { u32 order, agent, seq, len; };       // client_with_order
struct IoEntry  { u32 seq, order, len; };              // item_orders (per agent)
struct DelEntry { u32 op_order, target, len; };        // deletes log
struct DDEntry  { u32 target, len, excess; };          // double_deletes
struct TxnEntry {
    u32 order, len, shadow;
    std::vector<u32> parents;
};

struct ClientData {
    std::string name;
    std::vector<IoEntry> item_orders;
    u32 next_seq() const {
        if (item_orders.empty()) return 0;
        const IoEntry& e = item_orders.back();
        return e.seq + e.len;
    }
    // seq -> order (`doc.rs:26-29`); returns false if unknown.
    bool seq_to_order(u32 seq, u32* out) const {
        size_t lo = 0, hi = item_orders.size();
        while (lo < hi) {
            size_t mid = (lo + hi) / 2;
            if (item_orders[mid].seq <= seq) lo = mid + 1; else hi = mid;
        }
        if (lo == 0) return false;
        const IoEntry& e = item_orders[lo - 1];
        if (seq >= e.seq + e.len) return false;
        *out = e.order + (seq - e.seq);
        return true;
    }
    // Find the run containing seq: returns index or -1.
    int find_run(u32 seq) const {
        size_t lo = 0, hi = item_orders.size();
        while (lo < hi) {
            size_t mid = (lo + hi) / 2;
            if (item_orders[mid].seq <= seq) lo = mid + 1; else hi = mid;
        }
        if (lo == 0) return -1;
        const IoEntry& e = item_orders[lo - 1];
        if (seq >= e.seq + e.len) return -1;
        return (int)(lo - 1);
    }
};

// ---------------------------------------------------------------- doc ----

struct Doc {
    std::vector<Node> nodes;
    int root = NIL;
    Rng rng;
    // span start order -> node id. Splits only create new right halves;
    // the one op that changes an existing start is the prepend-merge fast
    // path, which re-keys its entry in place.
    std::map<u32, int> order_index;
    std::vector<u32> chars;  // codepoint per *insert* order (delete ops: gaps)
    std::vector<int> free_nodes;  // slots freed by the tombstone merge
    u32 n_spans = 0;              // live span count (nodes minus freed)

    std::vector<CwoEntry> client_with_order;
    std::vector<ClientData> clients;
    std::vector<DelEntry> deletes;
    std::vector<DDEntry> double_deletes;
    std::vector<TxnEntry> txns;
    std::vector<u32> frontier;

    std::string last_error;

    Doc() : rng(0x9E3779B97F4A7C15ULL) { frontier.push_back(ROOT_ORDER); }

    // ---- treap plumbing ----

    inline u32 raw(int t) const { return t == NIL ? 0 : nodes[t].sum_raw; }
    inline u32 content(int t) const { return t == NIL ? 0 : nodes[t].sum_content; }

    inline void pull(int t) {
        Node& n = nodes[t];
        n.sum_raw = uabs(n.len) + raw(n.l) + raw(n.r);
        n.sum_content = (u32)std::max(n.len, 0) + content(n.l) + content(n.r);
        if (n.l != NIL) nodes[n.l].p = t;
        if (n.r != NIL) nodes[n.r].p = t;
    }

    int new_node(u32 order, u32 ol, u32 orr, i32 len) {
        Node n;
        n.order = order; n.ol = ol; n.orr = orr; n.len = len;
        n.pri = rng.next();
        n.l = n.r = n.p = NIL;
        n.sum_raw = uabs(len);
        n.sum_content = (u32)std::max(len, 0);
        int id;
        if (!free_nodes.empty()) {
            id = free_nodes.back();
            free_nodes.pop_back();
            nodes[id] = n;
        } else {
            nodes.push_back(n);
            id = (int)nodes.size() - 1;
        }
        order_index[order] = id;
        n_spans++;
        return id;
    }

    // Detach a node the tombstone merge absorbed into a neighbor: its
    // orders are now covered by the neighbor's order_index entry. The
    // caller settles the order_index keys itself (the absorbed start key
    // is erased on an append-merge but RE-POINTED on a prepend-merge).
    void discard_node(int id) {
        free_nodes.push_back(id);
        n_spans--;
    }

    // Split at measure k: a = minimal prefix whose measure is k, b = rest.
    // BY_CONTENT=false splits by raw item count; BY_CONTENT=true splits by
    // live-char count (boundary tombstones, measure 0, go to b — "minimal
    // prefix"). The in-span cut keeps the `span.rs:33-45` origin fix-up:
    // right half gets order+off, origin_left = order+off-1. A content cut
    // can only land inside a live span, where raw and live offsets
    // coincide, so one inner branch serves both.
    // NB: `nodes` may reallocate inside new_node(); never hold a Node&
    // across it.
    template <bool BY_CONTENT>
    void split_impl(int t, u32 k, int* a, int* b) {
        if (t == NIL) { *a = *b = NIL; return; }
        u32 lm = BY_CONTENT ? content(nodes[t].l) : raw(nodes[t].l);
        u32 sl = BY_CONTENT ? (u32)std::max(nodes[t].len, 0)
                            : uabs(nodes[t].len);
        if (k <= lm) {
            int nl;
            split_impl<BY_CONTENT>(nodes[t].l, k, a, &nl);
            nodes[t].l = nl;
            *b = t;
            nodes[t].p = NIL;
            pull(t);
        } else if (k >= lm + sl) {
            int nr;
            split_impl<BY_CONTENT>(nodes[t].r, k - lm - sl, &nr, b);
            nodes[t].r = nr;
            *a = t;
            nodes[t].p = NIL;
            pull(t);
        } else {
            u32 off = k - lm;
            i32 sign = nodes[t].len < 0 ? -1 : 1;  // BY_CONTENT: always +1
            u32 o = nodes[t].order;
            u32 orr_ = nodes[t].orr;
            i32 rest_len = nodes[t].len - sign * (i32)off;
            int old_r = nodes[t].r;
            int rid = new_node(o + off, o + off - 1, orr_, rest_len);
            nodes[t].len = sign * (i32)off;
            // rid takes t's right subtree — it must inherit t's priority to
            // keep the heap invariant over that subtree.
            nodes[rid].pri = nodes[t].pri;
            nodes[rid].r = old_r;
            nodes[t].r = NIL;
            pull(rid);
            pull(t);
            *a = t; nodes[t].p = NIL;
            *b = rid; nodes[rid].p = NIL;
        }
    }

    void split(int t, u32 k, int* a, int* b) {
        split_impl<false>(t, k, a, b);
    }

    void split_content(int t, u32 k, int* a, int* b) {
        split_impl<true>(t, k, a, b);
    }

    int merge(int a, int b) {
        if (a == NIL) { if (b != NIL) nodes[b].p = NIL; return b; }
        if (b == NIL) { nodes[a].p = NIL; return a; }
        if (nodes[a].pri > nodes[b].pri) {
            int m = merge(nodes[a].r, b);
            nodes[a].r = m;
            pull(a);
            nodes[a].p = NIL;
            return a;
        } else {
            int m = merge(a, nodes[b].l);
            nodes[b].l = m;
            pull(b);
            nodes[b].p = NIL;
            return b;
        }
    }

    u32 n_raw() const { return raw(root); }
    u32 n_content() const { return content(root); }

    // Raw index of the item at content position p, rolling forward past
    // tombstones (cursor_at_content_pos(pos, false), `root.rs:406`).
    // p == content total -> n_raw() (end cursor).
    u32 raw_of_content(u32 p) const {
        int t = root;
        u32 base = 0;
        while (t != NIL) {
            const Node& n = nodes[t];
            u32 lc = content(n.l);
            if (p < lc) { t = n.l; continue; }
            p -= lc;
            u32 lr = raw(n.l);
            u32 c = (u32)std::max(n.len, 0);
            if (p < c) return base + lr + p;
            p -= c;
            base += lr + uabs(n.len);
            t = n.r;
        }
        return base;
    }

    // Content position count of live items strictly before raw index k.
    u32 content_before_raw(u32 k) const {
        int t = root;
        u32 acc = 0;
        while (t != NIL) {
            const Node& n = nodes[t];
            u32 lr = raw(n.l);
            u32 sl = uabs(n.len);
            if (k <= lr) { t = n.l; continue; }
            acc += content(n.l);
            if (k < lr + sl) {
                if (n.len > 0) acc += k - lr;
                return acc;
            }
            acc += (u32)std::max(n.len, 0);
            k -= lr + sl;
            t = n.r;
        }
        return acc;
    }

    // (node, offset) at raw index k; false at end.
    bool item_at_raw(u32 k, int* nid, u32* off) const {
        int t = root;
        while (t != NIL) {
            const Node& n = nodes[t];
            u32 lr = raw(n.l);
            u32 sl = uabs(n.len);
            if (k < lr) { t = n.l; continue; }
            if (k < lr + sl) { *nid = t; *off = k - lr; return true; }
            k -= lr + sl;
            t = n.r;
        }
        return false;
    }

    // Raw position of (node, offset) by walking parents — the analog of
    // `cursor.count_pos()` (`cursor.rs:147-190`), but in raw coordinates.
    u32 raw_position_of(int nid, u32 off) const {
        const Node& n = nodes[nid];
        u32 pos = raw(n.l) + off;
        int cur = nid;
        int par = n.p;
        while (par != NIL) {
            const Node& pn = nodes[par];
            if (pn.r == cur) pos += raw(pn.l) + uabs(pn.len);
            cur = par;
            par = pn.p;
        }
        return pos;
    }

    // Find the span node containing an item order (SpaceIndex analog,
    // `doc.rs:101-107`): the order_index map plays the role of the
    // order->leaf-pointer SplitList.
    bool node_of_order(u32 order, int* nid, u32* off) const {
        auto it = order_index.upper_bound(order);
        if (it == order_index.begin()) return false;
        --it;
        int t = it->second;
        const Node& n = nodes[t];
        if (order < n.order || order >= n.order + uabs(n.len)) return false;
        *nid = t; *off = order - n.order;
        return true;
    }

    // Raw cursor just after item `origin` (`doc.rs:121-136`).
    bool cursor_after(u32 origin, u32* out) const {
        if (origin == ROOT_ORDER) { *out = 0; return true; }
        int nid; u32 off;
        if (!node_of_order(origin, &nid, &off)) return false;
        *out = raw_position_of(nid, off) + 1;
        return true;
    }

    // ---- agents / orders ----

    int get_agent_id(const char* name) const {
        if (strcmp(name, "ROOT") == 0) return (int)AGENT_ROOT;
        for (size_t i = 0; i < clients.size(); i++)
            if (clients[i].name == name) return (int)i;
        return -2;  // unknown
    }

    u32 get_or_create_agent(const char* name) {
        int a = get_agent_id(name);
        if (a != -2) return (u32)a;
        ClientData cd; cd.name = name;
        clients.push_back(cd);
        return (u32)(clients.size() - 1);
    }

    u32 next_order() const {
        if (client_with_order.empty()) return 0;
        const CwoEntry& e = client_with_order.back();
        return e.order + e.len;
    }

    void assign_order_to_client(u32 agent, u32 seq, u32 order, u32 len) {
        // (`doc.rs:155-165`) with KVPair-style RLE merging.
        if (!client_with_order.empty()) {
            CwoEntry& e = client_with_order.back();
            if (e.order + e.len == order && e.agent == agent &&
                e.seq + e.len == seq) {
                e.len += len;
            } else {
                client_with_order.push_back({order, agent, seq, len});
            }
        } else {
            client_with_order.push_back({order, agent, seq, len});
        }
        ClientData& cd = clients[agent];
        if (!cd.item_orders.empty()) {
            IoEntry& e = cd.item_orders.back();
            if (e.seq + e.len == seq && e.order + e.len == order) {
                e.len += len;
                return;
            }
        }
        cd.item_orders.push_back({seq, order, len});
    }

    bool agent_of_order(u32 order, u32* agent) const {
        size_t lo = 0, hi = client_with_order.size();
        while (lo < hi) {
            size_t mid = (lo + hi) / 2;
            if (client_with_order[mid].order <= order) lo = mid + 1; else hi = mid;
        }
        if (lo == 0) return false;
        const CwoEntry& e = client_with_order[lo - 1];
        if (order >= e.order + e.len) return false;
        *agent = e.agent;
        return true;
    }

    bool loc_of_order(u32 order, u32* agent, u32* seq) const {
        size_t lo = 0, hi = client_with_order.size();
        while (lo < hi) {
            size_t mid = (lo + hi) / 2;
            if (client_with_order[mid].order <= order) lo = mid + 1; else hi = mid;
        }
        if (lo == 0) return false;
        const CwoEntry& e = client_with_order[lo - 1];
        if (order >= e.order + e.len) return false;
        *agent = e.agent;
        *seq = e.seq + (order - e.order);
        return true;
    }

    // ---- logs ----

    void deletes_append(u32 op_order, u32 target, u32 len) {
        if (!deletes.empty()) {
            DelEntry& e = deletes.back();
            if (e.op_order + e.len == op_order && e.target + e.len == target) {
                e.len += len;
                return;
            }
        }
        deletes.push_back({op_order, target, len});
    }

    // Gap-aware interval increment (`double_delete.rs:41-106`).
    void increment_delete_range(u32 base, u32 len) {
        // Find first entry with key > base, step back.
        size_t idx;
        {
            size_t lo = 0, hi = double_deletes.size();
            while (lo < hi) {
                size_t mid = (lo + hi) / 2;
                if (double_deletes[mid].target <= base) lo = mid + 1; else hi = mid;
            }
            if (lo > 0 && base < double_deletes[lo - 1].target +
                                  double_deletes[lo - 1].len)
                idx = lo - 1;
            else
                idx = lo;
        }
        u32 nb = base, nl = len;
        while (true) {
            if (idx == double_deletes.size() || double_deletes[idx].target > nb) {
                u32 this_len = nl;
                bool done = true;
                if (idx < double_deletes.size() &&
                    nb + nl > double_deletes[idx].target) {
                    this_len = double_deletes[idx].target - nb;
                    done = false;
                }
                if (idx >= 1 && double_deletes[idx - 1].target +
                                double_deletes[idx - 1].len == nb &&
                    double_deletes[idx - 1].excess == 1) {
                    double_deletes[idx - 1].len += this_len;
                } else {
                    double_deletes.insert(double_deletes.begin() + idx,
                                          {nb, this_len, 1});
                    idx++;
                }
                if (done) break;
                nb += this_len; nl -= this_len;
            }
            DDEntry& e = double_deletes[idx];
            if (e.target < nb) {
                u32 at = nb - e.target;
                DDEntry rest = {nb, e.len - at, e.excess};
                e.len = at;
                idx++;
                double_deletes.insert(double_deletes.begin() + idx, rest);
            }
            DDEntry& e2 = double_deletes[idx];
            if (e2.len <= nl) {
                e2.excess += 1;
                nb += e2.len; nl -= e2.len;
                if (nl == 0) break;
                idx++;
            } else {
                DDEntry rest = {nb + nl, e2.len - nl, e2.excess};
                e2.len = nl;
                e2.excess += 1;
                double_deletes.insert(double_deletes.begin() + idx + 1, rest);
                break;
            }
        }
    }

    // ---- time DAG (`doc.rs:34-48`, `:350-374`) ----

    bool branch_contains(const std::vector<u32>& b, u32 o) const {
        return std::find(b.begin(), b.end(), o) != b.end();
    }

    u32 txn_shadow_of(u32 order) const {
        size_t lo = 0, hi = txns.size();
        while (lo < hi) {
            size_t mid = (lo + hi) / 2;
            if (txns[mid].order <= order) lo = mid + 1; else hi = mid;
        }
        return txns[lo - 1].shadow;
    }

    void insert_txn(bool has_parents, std::vector<u32> parents,
                    u32 first_order, u32 len) {
        u32 last_order = first_order + len - 1;
        if (has_parents) {
            std::vector<u32> nf;
            for (u32 o : frontier)
                if (!branch_contains(parents, o)) nf.push_back(o);
            nf.push_back(last_order);
            frontier = nf;
        } else {
            parents = frontier;
            frontier.clear();
            frontier.push_back(last_order);
        }
        u32 shadow = first_order;
        while (shadow >= 1 && branch_contains(parents, shadow - 1))
            shadow = txn_shadow_of(shadow - 1);

        if (!txns.empty()) {
            TxnEntry& e = txns.back();
            if (parents.size() == 1 && parents[0] == e.order + e.len - 1 &&
                shadow == e.shadow) {
                e.len += len;
                return;
            }
        }
        TxnEntry t; t.order = first_order; t.len = len; t.shadow = shadow;
        t.parents = parents;
        txns.push_back(t);
    }

    // ---- integrate (`doc.rs:167-234`) ----

    // Bump every sum on the path node -> root by (draw, dcontent). The
    // in-place fast paths use this instead of full pull()s: one add per
    // level, no child re-reads.
    inline void bump_sums(int nid, i32 draw, i32 dcontent) {
        for (int c = nid; c != NIL; c = nodes[c].p) {
            nodes[c].sum_raw = (u32)((i32)nodes[c].sum_raw + draw);
            nodes[c].sum_content = (u32)((i32)nodes[c].sum_content + dcontent);
        }
    }

    // Insert a run at raw position `cursor`, merging into the predecessor
    // span when the YjsSpan append predicate allows (`span.rs:47-53`).
    // (No prepend case here: orders are allocated monotonically and
    // integrated immediately, so a fresh run can never precede an existing
    // span in order space. The reference's prepend optimization
    // `mutations.rs:84-109` is about *tombstones* — see local_deactivate.)
    void insert_run_at(u32 cursor, u32 order, u32 ol, u32 orr, u32 len) {
        // Fast path 1 (the typing hot path): the item just before the
        // cursor is the END of a live span the run appends to. Extend the
        // span in place — no split/merge node churn, just a sum walk.
        if (cursor > 0 && ol != ROOT_ORDER) {
            int nid; u32 off;
            if (item_at_raw(cursor - 1, &nid, &off)) {
                Node& pn = nodes[nid];
                if (pn.len > 0 && off == (u32)pn.len - 1 &&
                    order == pn.order + (u32)pn.len &&
                    ol == order - 1 && orr == pn.orr) {
                    pn.len += (i32)len;
                    bump_sums(nid, (i32)len, (i32)len);
                    return;
                }
            }
        }
        int a, b;
        split(root, cursor, &a, &b);
        int nn = new_node(order, ol, orr, (i32)len);
        root = merge(merge(a, nn), b);
    }

    bool integrate(u32 agent, u32 order, u32 ol, u32 orr, u32 len,
                   bool have_cursor, u32 cursor_in) {
        u32 cursor;
        if (have_cursor) cursor = cursor_in;
        else if (!cursor_after(ol, &cursor)) return fail("unknown origin_left");

        u32 left_cursor = cursor;
        u32 scan_start = cursor;
        bool scanning = false;
        u32 n = n_raw();

        while (cursor < n) {
            int nid; u32 off;
            if (!item_at_raw(cursor, &nid, &off)) break;
            const Node& on = nodes[nid];
            u32 other_order = on.order + off;
            if (other_order == orr) break;
            u32 other_left = (off == 0) ? on.ol : other_order - 1;
            u32 olc;
            if (!cursor_after(other_left, &olc))
                return fail("unknown other origin_left");
            if (olc < left_cursor) break;
            if (olc == left_cursor) {
                u32 other_agent;
                if (!agent_of_order(on.order, &other_agent))
                    return fail("unknown agent of span");
                const std::string& my_name = clients[agent].name;
                const std::string& other_name = clients[other_agent].name;
                if (my_name > other_name) {
                    scanning = false;
                } else if (orr == on.orr) {
                    break;
                } else {
                    // Pin on the first conflicting item only — see
                    // models/oracle.py on the reference's `doc.rs:214-216`.
                    if (!scanning) scan_start = cursor;
                    scanning = true;
                }
            }
            cursor++;
        }
        if (scanning) cursor = scan_start;
        insert_run_at(cursor, order, ol, orr, len);
        return true;
    }

    // ---- local edits (`doc.rs:376-469`) ----

    bool fail(const char* msg) { last_error = msg; return false; }

    // Tombstone del_span live items from content pos (`mutations.rs:520-570`).
    // Appends delete-log entries using op orders starting at *next_order_io.
    bool local_deactivate(u32 pos, u32 del_span, u32* next_order_io) {
        if (pos + del_span > n_content()) return fail("delete past end");
        u32 i = raw_of_content(pos);
        int a, m, c, rest;
        split(root, i, &a, &rest);
        // Content split keeps boundary tombstones out of m, so flip_live
        // walks exactly the spans covering the del_span live chars.
        split_content(rest, del_span, &m, &c);
        // Flip all live spans in m (in-order), collecting delete runs.
        std::vector<std::pair<u32, u32>> runs;
        flip_live(m, runs);
        // Tombstone boundary merge — the real analog of the reference's
        // prepend optimization (`mutations.rs:84-109`, "improves
        // performance when the user hits backspace... merging all the
        // deleted elements together"): when the freshly flipped span is a
        // single node, try to absorb it into an order-adjacent tombstone
        // neighbor (the span.rs:47-53 predicate, both signs negative).
        // Backspace runs merge rightward; forward-delete runs leftward.
        if (m != NIL && nodes[m].l == NIL && nodes[m].r == NIL) {
            const Node& mn = nodes[m];
            if (a != NIL) {   // append m after a's rightmost span
                int t = a;
                while (nodes[t].r != NIL) t = nodes[t].r;
                const Node& ra = nodes[t];
                if (ra.len < 0 && mn.order == ra.order + uabs(ra.len) &&
                    mn.ol == mn.order - 1 && mn.orr == ra.orr) {
                    u32 grow = uabs(mn.len);
                    order_index.erase(mn.order);
                    nodes[t].len -= (i32)grow;   // more negative
                    for (int w = a; ; w = nodes[w].r) {
                        nodes[w].sum_raw += grow;
                        if (w == t) break;
                    }
                    discard_node(m);
                    root = merge(a, c);
                    return finish_deactivate(runs, next_order_io);
                }
            }
            if (c != NIL) {   // prepend m before c's leftmost span
                int t = c;
                while (nodes[t].l != NIL) t = nodes[t].l;
                const Node& cl = nodes[t];
                if (cl.len < 0 && cl.order == mn.order + uabs(mn.len) &&
                    cl.ol == cl.order - 1 && cl.orr == mn.orr) {
                    u32 grow = uabs(mn.len);
                    order_index.erase(cl.order);
                    nodes[t].order = mn.order;
                    nodes[t].ol = mn.ol;
                    nodes[t].len -= (i32)grow;
                    order_index[mn.order] = t;  // re-points m's old entry
                    for (int w = c; ; w = nodes[w].l) {
                        nodes[w].sum_raw += grow;
                        if (w == t) break;
                    }
                    discard_node(m);
                    root = merge(a, c);
                    return finish_deactivate(runs, next_order_io);
                }
            }
        }
        root = merge(merge(a, m), c);
        return finish_deactivate(runs, next_order_io);
    }

    bool finish_deactivate(const std::vector<std::pair<u32, u32>>& runs,
                           u32* next_order_io) {
        u32 nord = *next_order_io;
        for (auto& rn : runs) {
            deletes_append(nord, rn.first, rn.second);
            nord += rn.second;
        }
        *next_order_io = nord;
        return true;
    }

    void flip_live(int t, std::vector<std::pair<u32, u32>>& runs) {
        if (t == NIL) return;
        Node& n = nodes[t];
        flip_live(n.l, runs);
        if (n.len > 0) {
            // extend_delete RLE merge on consecutive target orders
            // (`root.rs:9-17`).
            if (!runs.empty() &&
                runs.back().first + runs.back().second == n.order)
                runs.back().second += (u32)n.len;
            else
                runs.push_back({n.order, (u32)n.len});
            n.len = -n.len;
        }
        flip_live(n.r, runs);
        pull(t);
    }

    bool local_insert_op(u32 agent, u32 pos, const u32* cps, u32 ins_len,
                         u32 order) {
        u32 origin_left, cursor;
        if (pos == 0) {
            origin_left = ROOT_ORDER;
            cursor = 0;
        } else {
            if (pos > n_content()) return fail("insert pos out of range");
            u32 li = raw_of_content(pos - 1);
            int nid; u32 off;
            if (!item_at_raw(li, &nid, &off)) return fail("bad content pos");
            origin_left = nodes[nid].order + off;
            cursor = li + 1;
        }
        // origin_right: next item in raw order even if deleted
        // (`doc.rs:452-453` quirk kept).
        u32 origin_right = ROOT_ORDER;
        {
            int nid; u32 off;
            if (item_at_raw(cursor, &nid, &off))
                origin_right = nodes[nid].order + off;
        }
        for (u32 k = 0; k < ins_len; k++) chars_set(order + k, cps[k]);
        return integrate(agent, order, origin_left, origin_right, ins_len,
                         true, cursor);
    }

    void chars_set(u32 order, u32 cp) {
        if (chars.size() <= order) chars.resize(order + 1, 0);
        chars[order] = cp;
    }

    bool apply_local_txn(u32 agent, u32 n_ops, const u32* pos_arr,
                         const u32* del_arr, const u32* ins_len_arr,
                         const u32* ins_cps /* concatenated */) {
        u32 first_order = next_order();
        u32 next = first_order;
        u32 txn_span = 0;
        for (u32 i = 0; i < n_ops; i++)
            txn_span += del_arr[i] + ins_len_arr[i];
        if (txn_span == 0) return fail("empty txn");
        assign_order_to_client(agent, clients[agent].next_seq(), first_order,
                               txn_span);
        const u32* cp = ins_cps;
        for (u32 i = 0; i < n_ops; i++) {
            if (del_arr[i] > 0) {
                if (!local_deactivate(pos_arr[i], del_arr[i], &next))
                    return false;
            }
            if (ins_len_arr[i] > 0) {
                u32 order = next;
                next += ins_len_arr[i];
                if (!local_insert_op(agent, pos_arr[i], cp, ins_len_arr[i],
                                     order))
                    return false;
                cp += ins_len_arr[i];
            }
        }
        insert_txn(false, {}, first_order, txn_span);
        return true;
    }

    // ---- remote edits (`doc.rs:242-348`) ----

    bool remote_deactivate_chunk(u32 target, u32 chunk_len, u32* dd_base,
                                 u32* dd_len) {
        // Deactivate chunk_len order-consecutive items starting at `target`;
        // they may be fragmented in doc order (`doc.rs:310-334`).
        u32 remaining = chunk_len;
        while (remaining > 0) {
            int nid; u32 off;
            if (!node_of_order(target, &nid, &off))
                return fail("unknown delete target");
            u32 span_rest = uabs(nodes[nid].len) - off;
            u32 m = std::min(span_rest, remaining);
            bool was_deleted = nodes[nid].len < 0;
            if (was_deleted) {
                // Already deleted by another peer: count double deletes
                // (`mutations.rs:579-615` negative return path).
                if (*dd_len > 0 && *dd_base + *dd_len == target) {
                    *dd_len += m;
                } else {
                    if (*dd_len > 0) increment_delete_range(*dd_base, *dd_len);
                    *dd_base = target; *dd_len = m;
                }
            } else {
                u32 k = raw_position_of(nid, off);
                int a, mm, c;
                split(root, k + m, &a, &c);
                split(a, k, &a, &mm);
                // mm is exactly one span of m live items.
                nodes[mm].len = -nodes[mm].len;
                pull(mm);
                root = merge(merge(a, mm), c);
            }
            target += m;
            remaining -= m;
        }
        return true;
    }

    bool apply_remote_ins(u32 agent, u32 order, u32 ol, u32 orr,
                          const u32* cps, u32 len) {
        for (u32 k = 0; k < len; k++) chars_set(order + k, cps[k]);
        return integrate(agent, order, ol, orr, len, false, 0);
    }

    bool apply_remote_del(u32 target_agent, u32 seq, u32 total_len,
                          u32 op_order) {
        // Walk targets in seq space chunked through our item_orders runs
        // (see models/oracle.py rationale).
        ClientData& cd = clients[target_agent];
        u32 remaining = total_len, consumed = 0;
        u32 dd_base = 0, dd_len = 0;
        while (remaining > 0) {
            int ri = cd.find_run(seq);
            if (ri < 0) return fail("unknown delete target seq");
            const IoEntry& e = cd.item_orders[ri];
            u32 off = seq - e.seq;
            u32 run_len = std::min(e.len - off, remaining);
            u32 target = e.order + off;
            deletes_append(op_order + consumed, target, run_len);
            if (!remote_deactivate_chunk(target, run_len, &dd_base, &dd_len))
                return false;
            seq += run_len; consumed += run_len; remaining -= run_len;
        }
        if (dd_len > 0) increment_delete_range(dd_base, dd_len);
        return true;
    }

    // ---- read-back ----

    void collect_spans(int t, std::vector<Node>& out) const {
        if (t == NIL) return;
        collect_spans(nodes[t].l, out);
        out.push_back(nodes[t]);
        collect_spans(nodes[t].r, out);
    }

    std::string to_string_utf8() const {
        std::vector<Node> spans;
        collect_spans(root, spans);
        std::string out;
        out.reserve(n_content() * 2);
        for (const Node& s : spans) {
            if (s.len <= 0) continue;
            for (i32 k = 0; k < s.len; k++) {
                u32 cp = (s.order + (u32)k) < chars.size()
                             ? chars[s.order + (u32)k] : 0;
                // UTF-8 encode.
                if (cp < 0x80) out.push_back((char)cp);
                else if (cp < 0x800) {
                    out.push_back((char)(0xC0 | (cp >> 6)));
                    out.push_back((char)(0x80 | (cp & 0x3F)));
                } else if (cp < 0x10000) {
                    out.push_back((char)(0xE0 | (cp >> 12)));
                    out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
                    out.push_back((char)(0x80 | (cp & 0x3F)));
                } else {
                    out.push_back((char)(0xF0 | (cp >> 18)));
                    out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
                    out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
                    out.push_back((char)(0x80 | (cp & 0x3F)));
                }
            }
        }
        return out;
    }
};

// ------------------------------------------------------------- C ABI ----

extern "C" {

void* tcr_new() { return new Doc(); }
void tcr_free(void* d) { delete (Doc*)d; }

const char* tcr_last_error(void* d) { return ((Doc*)d)->last_error.c_str(); }

u32 tcr_get_or_create_agent(void* d, const char* name) {
    return ((Doc*)d)->get_or_create_agent(name);
}

u32 tcr_len(void* d) { return ((Doc*)d)->n_content(); }
u32 tcr_raw_len(void* d) { return ((Doc*)d)->n_raw(); }
u32 tcr_next_order(void* d) { return ((Doc*)d)->next_order(); }
u32 tcr_num_spans(void* d) { return ((Doc*)d)->n_spans; }

// Actual allocation of the document (the `alloc.rs:40-50` role): every
// live vector/map buffer, in bytes.
unsigned long long tcr_memory_bytes(void* dv) {
    Doc* d = (Doc*)dv;
    unsigned long long b = 0;
    b += d->nodes.capacity() * sizeof(Node);
    b += d->order_index.size() * (sizeof(u32) + sizeof(int) + 48);  // map node
    b += d->chars.capacity() * sizeof(u32);
    b += d->free_nodes.capacity() * sizeof(int);
    b += d->client_with_order.capacity() * sizeof(CwoEntry);
    b += d->deletes.capacity() * sizeof(DelEntry);
    b += d->double_deletes.capacity() * sizeof(DDEntry);
    b += d->txns.capacity() * sizeof(TxnEntry);
    b += d->frontier.capacity() * sizeof(u32);
    for (auto& c : d->clients) {
        b += sizeof(ClientData) + c.name.size();
        b += c.item_orders.capacity() * sizeof(IoEntry);
    }
    return b;
}

int tcr_apply_local_txn(void* dv, u32 agent, u32 n_ops, const u32* pos,
                        const u32* dels, const u32* ins_lens,
                        const u32* ins_cps) {
    Doc* d = (Doc*)dv;
    if (agent >= d->clients.size()) {
        d->last_error = "invalid agent id";
        return -1;
    }
    return d->apply_local_txn(agent, n_ops, pos, dels, ins_lens, ins_cps)
               ? 0 : -1;
}

int tcr_local_insert(void* dv, u32 agent, u32 pos, const u32* cps, u32 len) {
    u32 zero = 0;
    return tcr_apply_local_txn(dv, agent, 1, &pos, &zero, &len, cps);
}

int tcr_local_delete(void* dv, u32 agent, u32 pos, u32 del_span) {
    u32 zero = 0;
    return tcr_apply_local_txn(dv, agent, 1, &pos, &del_span, &zero, nullptr);
}

// Remote txn, pre-resolved by the Python wrapper into numeric form:
//   agent: local agent id (created by caller)
//   seq:   txn start seq
//   parents: array of orders (already remote_id_to_order-mapped), len n_parents
//   ops encoded as flat arrays: kinds[i] (0=ins, 1=del),
//     A[i]: ins -> origin_left order; del -> target agent id
//     B[i]: ins -> origin_right order; del -> target seq
//     L[i]: op length
//   cps: concatenated insert codepoints.
int tcr_apply_remote_txn(void* dv, u32 agent, u32 seq, const u32* parents,
                         u32 n_parents, u32 n_ops, const u32* kinds,
                         const u32* A, const u32* B, const u32* L,
                         const u32* cps) {
    Doc* d = (Doc*)dv;
    if (agent >= d->clients.size()) {
        d->last_error = "invalid agent id (ROOT cannot author txns)";
        return -1;
    }
    for (u32 i = 0; i < n_ops; i++) {
        if (kinds[i] == 1 && A[i] >= d->clients.size()) {
            d->last_error = "invalid delete target agent";
            return -1;
        }
    }
    if (d->clients[agent].next_seq() != seq) {
        d->last_error = "remote txn out of order";
        return -1;
    }
    u32 first_order = d->next_order();
    u32 txn_len = 0;
    for (u32 i = 0; i < n_ops; i++) txn_len += L[i];
    if (txn_len == 0) { d->last_error = "empty txn"; return -1; }
    d->assign_order_to_client(agent, seq, first_order, txn_len);
    u32 next = first_order;
    const u32* cp = cps;
    for (u32 i = 0; i < n_ops; i++) {
        if (kinds[i] == 0) {
            if (L[i] == 0) continue;
            u32 order = next; next += L[i];
            if (!d->apply_remote_ins(agent, order, A[i], B[i], cp, L[i]))
                return -1;
            cp += L[i];
        } else {
            u32 order = next; next += L[i];
            if (!d->apply_remote_del(A[i], B[i], L[i], order)) return -1;
        }
    }
    std::vector<u32> ps(parents, parents + n_parents);
    d->insert_txn(true, ps, first_order, txn_len);
    return 0;
}

u32 tcr_seq_to_order(void* dv, u32 agent, u32 seq) {
    Doc* d = (Doc*)dv;
    if (agent == AGENT_ROOT) return ROOT_ORDER;
    u32 out;
    if (!d->clients[agent].seq_to_order(seq, &out)) return ROOT_ORDER;
    return out;
}

int tcr_agent_id(void* dv, const char* name) {
    return ((Doc*)dv)->get_agent_id(name);
}

// Dump the document body spans in doc order. Returns span count
// (call with cap=0 to size). Arrays: order, origin_left, origin_right,
// signed len.
u32 tcr_get_spans(void* dv, u32* order, u32* ol, u32* orr, i32* len, u32 cap) {
    Doc* d = (Doc*)dv;
    std::vector<Node> spans;
    d->collect_spans(d->root, spans);
    u32 n = (u32)spans.size();
    if (cap >= n && order) {
        for (u32 i = 0; i < n; i++) {
            order[i] = spans[i].order;
            ol[i] = spans[i].ol;
            orr[i] = spans[i].orr;
            len[i] = spans[i].len;
        }
    }
    return n;
}

u32 tcr_get_frontier(void* dv, u32* out, u32 cap) {
    Doc* d = (Doc*)dv;
    u32 n = (u32)d->frontier.size();
    if (cap >= n && out)
        for (u32 i = 0; i < n; i++) out[i] = d->frontier[i];
    return n;
}

u32 tcr_get_deletes(void* dv, u32* op_order, u32* target, u32* len, u32 cap) {
    Doc* d = (Doc*)dv;
    u32 n = (u32)d->deletes.size();
    if (cap >= n && op_order)
        for (u32 i = 0; i < n; i++) {
            op_order[i] = d->deletes[i].op_order;
            target[i] = d->deletes[i].target;
            len[i] = d->deletes[i].len;
        }
    return n;
}

u32 tcr_get_double_deletes(void* dv, u32* target, u32* len, u32* excess,
                           u32 cap) {
    Doc* d = (Doc*)dv;
    u32 n = (u32)d->double_deletes.size();
    if (cap >= n && target)
        for (u32 i = 0; i < n; i++) {
            target[i] = d->double_deletes[i].target;
            len[i] = d->double_deletes[i].len;
            excess[i] = d->double_deletes[i].excess;
        }
    return n;
}

u32 tcr_text_utf8(void* dv, char* buf, u32 cap) {
    std::string s = ((Doc*)dv)->to_string_utf8();
    u32 n = (u32)s.size();
    if (cap >= n && buf) memcpy(buf, s.data(), n);
    return n;
}

// Replay a whole pre-flattened local-edit trace in one call (the CPU
// baseline path, mirroring `benches/yjs.rs:32-49`). Patches arrays:
// pos[i], del[i], ins_len[i]; cps = concatenated insert codepoints.
// One txn per patch. Returns 0 or -1.
int tcr_replay_trace(void* dv, u32 agent, u32 n_patches, const u32* pos,
                     const u32* dels, const u32* ins_lens, const u32* cps) {
    Doc* d = (Doc*)dv;
    if (agent >= d->clients.size()) {
        d->last_error = "invalid agent id";
        return -1;
    }
    const u32* cp = cps;
    for (u32 i = 0; i < n_patches; i++) {
        if (!d->apply_local_txn(agent, 1, &pos[i], &dels[i], &ins_lens[i], cp))
            return -1;  // failing patch context is in last_error
        cp += ins_lens[i];
    }
    return 0;
}

// Text-only replay baseline (`benches/ropey.rs:12-38` analog): a gap
// buffer of u32 codepoints — the rope stand-in that measures what the
// same edit stream costs with NO CRDT metadata at all, the lower bound
// CRDT numbers are judged against. Returns the final length; if `out`
// is non-null and holds >= that many u32s, the final content is copied.
long long tcr_rope_replay(u32 n_patches, const u32* pos, const u32* dels,
                          const u32* ins_lens, const u32* cps,
                          u32* out, u32 out_cap) {
    std::vector<u32> buf(4096);
    size_t gap_at = 0, gap_len = buf.size();  // [gap_at, gap_at+gap_len)
    const u32* cp = cps;
    for (u32 i = 0; i < n_patches; i++) {
        size_t n = buf.size() - gap_len;
        size_t p = pos[i], d = dels[i], il = ins_lens[i];
        if (p > n || p + d > n) return -1;
        // Move the gap to p (the rope's cursor locality: consecutive
        // edits at nearby positions cost near-zero moves).
        if (p < gap_at) {
            std::memmove(buf.data() + p + gap_len, buf.data() + p,
                         (gap_at - p) * sizeof(u32));
            gap_at = p;
        } else if (p > gap_at) {
            std::memmove(buf.data() + gap_at, buf.data() + gap_at + gap_len,
                         (p - gap_at) * sizeof(u32));
            gap_at = p;
        }
        gap_len += d;  // delete = widen the gap over the removed chars
        if (il > gap_len) {  // grow: double until the insert fits
            size_t live = buf.size() - gap_len;  // post-delete live count
            size_t tail = buf.size() - (gap_at + gap_len);
            size_t need = buf.size();
            while (need - live < il) need *= 2;
            std::vector<u32> nb(need);
            std::memcpy(nb.data(), buf.data(), gap_at * sizeof(u32));
            std::memcpy(nb.data() + need - tail,
                        buf.data() + buf.size() - tail, tail * sizeof(u32));
            gap_len = need - live;
            buf.swap(nb);
        }
        std::memcpy(buf.data() + gap_at, cp, il * sizeof(u32));
        cp += il;
        gap_at += il;
        gap_len -= il;
    }
    size_t n = buf.size() - gap_len;
    if (out && out_cap >= n) {
        std::memcpy(out, buf.data(), gap_at * sizeof(u32));
        std::memcpy(out + gap_at, buf.data() + gap_at + gap_len,
                    (n - gap_at) * sizeof(u32));
    }
    return (long long)n;
}

}  // extern "C"
