"""Port of `nos_tpu/runtime/radix_tree.py`, copied verbatim apart from
references to the reference's change history in the comments (host-only
code; the port imports nothing of the JAX package).

RadixTree: the structural index of the prefix cache — a tree over
token-block edges.

The content-addressed index is FLAT: `chain_key` commits a sha256 to
the whole prefix ending at a block, and admission walks the key chain
block by block. That shape can only share *fully equal leading blocks*,
which leaves three production reuse patterns invisible (the gap SGLang's
RadixAttention names over vLLM-style full-prefix matching):

  - **mid-block divergence** — thousands of conversations share a
    system prompt but diverge inside a block; the flat index serves
    nothing past the last fully-equal block, even though the diverging
    block's KV is identical up to the divergence point;
  - **multi-turn growth** — a follow-up turn re-submits
    `history + new tokens`; the generated half of the history was never
    keyed (decode pages are unkeyed), so turn N re-prefills turn N-1's
    output forever;
  - **structural eviction** — the flat LRU evicts hot trunk blocks as
    readily as cold leaves, so one deep cold path can evict the shared
    system prompt every admission wave.

This module adds the STRUCTURE those patterns need, and only the
structure: nodes mirror the chain-key space (one node per full token
block, keyed by the SAME `chain_key` sha256 the flat index and the
cluster router already use — tree keys and chain keys agree by
construction, so the flat `_prefix_index` remains the device-residency
truth and the spill tier remains the host-residency truth). The tree
itself never touches a block id, a payload, or a device: residency is
always supplied by the caller as predicates, which is what lets the
router's shadow (nos_tpu/serving/replica.py) reuse the exact walk code
against its believed-resident key set.

The walk (`match`) returns a three-part plan in prefix order:

  1. the contiguous DEVICE run (nodes whose keys the caller maps
     straight into the page table with refcount bumps),
  2. its contiguous HOST continuation (nodes staged as pending revives
     — the spill tier is the tree's cold storage),
  3. at the first non-resident edge, at most one COPY-ON-WRITE match:
     the resident child sharing the longest token prefix with the
     query's next block, and how many tokens of it may be copied into a
     *private* page (always capped below the prompt's last token, so
     the final prefill chunk — and its first-token sample — always
     remains). Shared nodes stay immutable: COW copies INTO a private
     block, never writes a shared one, so the disjoint-WRITE-set tick
     contract is untouched.

Node refcounts (`_node_ref`) count page tables mapping the node's
indexed block PLUS resident children — the invariant the randomized
pool test asserts at every step ("node refcount == number of mapping
page tables + child refs"). A node at refcount 0 with no children and
no residency in either tier is pruned; a data-less node with resident
descendants stays as a tombstone (it ends hit runs early, exactly like
a missing chain key in the flat index — never worse).

Every mutation of the tree's structure (`_edges`, `_node_ref`,
`_nodes`) lives inside this module's two classes — enforced by the
NOS017 checker (docs/static-analysis.md), mirroring NOS011/NOS013's
single-mutator discipline: tree surgery scattered into the engine or
the router is a lint finding in the reference package.
"""

from __future__ import annotations

import hashlib
from typing import Callable, List, Optional, Sequence, Tuple


def chain_key(parent: str, tokens: Sequence[int]) -> str:
    """Content key of one full block: sha256 chained over (parent key,
    the block's token ids). The chain makes a key a commitment to the
    whole prefix ending at this block — equal keys mean equal token
    prefixes (sha256 collisions are the only exception, which is the
    standard bet prefix caches make; the radix tree carries the exact
    token edges, so an exact-compare walk is one predicate swap away if
    the bet ever stops being acceptable)."""
    payload = parent + ":" + ",".join(str(int(t)) for t in tokens)
    return hashlib.sha256(payload.encode()).hexdigest()


def prompt_chain_keys(
    prompt: Sequence[int], block_size: int, salt: str = ""
) -> List[str]:
    """Chain keys for every block FULLY covered by `prompt`, in prefix
    order. Module-level so the cluster router (nos_tpu/serving/router.py)
    computes the SAME keys engines index under — router keys and engine
    keys agree by construction, never by convention.

    `salt` seeds the chain's root parent, giving the key space an extra
    dimension: an int8-pool engine salts with its payload dtype
    (docs/quantized-kv.md), so its keys can NEVER collide with an fp16
    replica's in a shared FleetKVStore — a native pool cannot even look
    up quantized bytes, let alone revive them. The router keeps the
    unsalted space; against a salted engine its prefix scores read 0,
    which only costs routing affinity, never correctness."""
    keys: List[str] = []
    parent = salt
    for b in range(len(prompt) // block_size):
        parent = chain_key(parent, prompt[b * block_size : (b + 1) * block_size])
        keys.append(parent)
    return keys


def cacheable_block_cap(n_tokens: int, block_size: int) -> int:
    """How many leading FULL blocks of an `n_tokens` prompt may be
    served from cache: everything strictly below the block holding the
    prompt's last token. That block is always recomputed privately —
    (a) the final prefill chunk must be non-empty (the first-token
    sample needs logits at the true last position) and (b) it keeps
    every post-admission write inside private pages, so shared blocks
    stay immutable. ONE helper, used by `BlockManager.peek_prefix`,
    `BlockManager.admit`, the tree walk, AND the router's scoring
    (serving/router.py) — router and engine can never disagree on the
    cap because neither writes the arithmetic."""
    return max(0, (n_tokens - 1) // block_size)


#: One staged copy-on-write match: (source chain key, tokens to copy
#: from the source block's head, whether the source is device-resident
#: — False means the copy reads the host tier's payload instead).
CowMatch = Tuple[str, int, bool]


class RadixNode:
    """One full token block in the prefix space. Dumb struct: every
    structural mutation happens in RadixTree methods (NOS017); readers
    may inspect freely."""

    __slots__ = ("key", "tokens", "parent", "_edges", "_node_ref")

    def __init__(self, key: str, tokens: Tuple[int, ...], parent):
        self.key = key
        self.tokens = tokens
        self.parent = parent
        #: child token-tuple -> RadixNode. Keyed by the FULL edge label:
        #: exact continuation is O(1); partial (COW) matching iterates —
        #: fanout at a divergence point is traffic-bounded and small.
        self._edges = {}
        #: page tables mapping this node's indexed block + resident
        #: children. 0 + no children + no residency => prunable.
        self._node_ref = 0


class RadixTree:
    """The tree. Residency-agnostic: callers supply `dev`/`host`
    predicates over chain keys (the BlockManager passes its index and
    spill tier; the router shadow passes its believed-resident set)."""

    def __init__(self, key_salt: str = "") -> None:
        self._root = RadixNode("", (), None)
        self._nodes = {}  # key -> RadixNode
        #: chain-key root salt (see `prompt_chain_keys`): every key this
        #: tree derives itself is salted identically, so a tree never
        #: mixes key spaces.
        self.key_salt = key_salt

    # -- queries -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._nodes)

    def node(self, key: str) -> Optional[RadixNode]:
        return self._nodes.get(key)

    def node_ref(self, key: str) -> int:
        node = self._nodes.get(key)
        return 0 if node is None else node._node_ref

    def children_keys(self, key: str) -> List[str]:
        node = self._root if key == "" else self._nodes.get(key)
        if node is None:
            return []
        return [child.key for child in node._edges.values()]

    def has_resident_child(self, key: str, resident: Callable[[str], bool]) -> bool:
        """Whether any direct child's key satisfies `resident` — the
        subtree-LRU eviction predicate (evict leaves before trunks, so
        the device run of a hot path is never holed by its own LRU)."""
        node = self._root if key == "" else self._nodes.get(key)
        if node is None:
            return False
        return any(resident(child.key) for child in node._edges.values())

    def match(
        self,
        prompt: Sequence[int],
        block_size: int,
        dev: Callable[[str], bool],
        host: Optional[Callable[[str], bool]] = None,
    ) -> Tuple[List[str], List[str], Optional[CowMatch]]:
        """THE walk — deepest resident match for `prompt`, as the
        three-part plan (device keys, host keys, optional COW match)
        described in the module docstring. Read-only: probing never
        mutates structure, refcounts, or any recency order (the router
        probes replicas through this; the peek-must-not-perturb
        property test covers the BlockManager wrapper).

        The runs are CONTIGUOUS by construction: the device run stops at
        the first edge that is missing or not device-resident, the host
        run continues while edges are host-resident, and the plan ends
        at the first edge resident in neither tier (a tombstone ends a
        run exactly like a missing chain key would). A device-resident
        node BEHIND a host gap is deliberately not mapped — the prefill
        cursor is a single contiguous frontier, and leaf-preferred
        eviction keeps device residency prefix-closed per path, so the
        conservative stop costs ~nothing in practice.

        The COW match is capped below the prompt's LAST token (the
        final chunk must remain — `cacheable_block_cap`'s argument at
        token granularity), and applies to the last, partial block too:
        the copy lands in a private page, so the immutability argument
        that forbids *mapping* the last-token block does not forbid
        copying its head."""
        host = host if host is not None else (lambda _key: False)
        cap = cacheable_block_cap(len(prompt), block_size)
        node = self._root
        dev_keys: List[str] = []
        host_keys: List[str] = []
        i = 0
        while i < cap:
            child = node._edges.get(
                tuple(prompt[i * block_size : (i + 1) * block_size])
            )
            if child is None or not dev(child.key):
                break
            dev_keys.append(child.key)
            node = child
            i += 1
        while i < cap:
            child = node._edges.get(
                tuple(prompt[i * block_size : (i + 1) * block_size])
            )
            if child is None or not host(child.key):
                break
            host_keys.append(child.key)
            node = child
            i += 1
        cow: Optional[CowMatch] = None
        tail = tuple(prompt[i * block_size : (i + 1) * block_size])
        # Copy at most up to (not including) the prompt's last token.
        limit = min(len(tail), len(prompt) - 1 - i * block_size)
        if limit > 0:
            best_len, best_key, best_dev = 0, "", False
            for child in node._edges.values():
                on_dev = dev(child.key)
                on_host = not on_dev and host(child.key)
                if not (on_dev or on_host):
                    continue
                j = 0
                child_tokens = child.tokens
                while j < limit and child_tokens[j] == tail[j]:
                    j += 1
                # Longest copy wins; on a tie, prefer a device source
                # (no host payload read), then first-inserted (dict
                # order — deterministic for a deterministic op order).
                if j > best_len or (j == best_len and j and on_dev and not best_dev):
                    best_len, best_key, best_dev = j, child.key, on_dev
            if best_len > 0:
                cow = (best_key, best_len, best_dev)
        return dev_keys, host_keys, cow

    def continuation(
        self,
        tokens: Sequence[int],
        block_size: int,
        dev: Callable[[str], bool],
        k: int,
    ) -> List[int]:
        """Draft probe for cache-fed speculation (docs/speculation.md):
        walk the tree to the deepest node matching `tokens` (a slot's
        prompt + generated history) and return up to `k` tokens of the
        continuation stored PAST that frontier — what some earlier
        request generated or prefilled after this exact prefix. The
        caller verifies the draft through the normal acceptance path, so
        a stale or diverged continuation costs a rejected window, never
        a wrong token.

        Read-only with `peek_prefix`'s no-touch contract: no refcount,
        no LRU recency, no structural mutation, and NO payload read —
        the probe consumes only the token labels the tree already holds
        on host. Continuation nodes must be DEVICE-resident: a spilled
        or store-resident continuation ends the draft rather than
        staging a revive (speculation must never cause tier traffic; a
        draft is a hint, not a mapping). The matched PREFIX, by
        contrast, is walked structurally without residency checks — its
        tokens equal the query by construction and contribute nothing
        to the draft.

        Where several children continue the frontier (mid-block: same
        `r`-token head; block-aligned: any child), the FIRST qualifying
        child in edge-insertion order wins — deterministic for a
        deterministic op order, the same argument as `match`'s COW
        tiebreak."""
        if k <= 0:
            return []
        node = self._root
        n_full = len(tokens) // block_size
        for b in range(n_full):
            child = node._edges.get(
                tuple(tokens[b * block_size : (b + 1) * block_size])
            )
            if child is None:
                return []
            node = child
        out: List[int] = []
        r = len(tokens) - n_full * block_size
        if r:
            tail = tuple(tokens[n_full * block_size :])
            nxt = None
            for child in node._edges.values():
                if child.tokens[:r] == tail and dev(child.key):
                    nxt = child
                    break
            if nxt is None:
                return []
            out.extend(nxt.tokens[r:])
            node = nxt
        while len(out) < k:
            nxt = None
            for child in node._edges.values():
                if dev(child.key):
                    nxt = child
                    break
            if nxt is None:
                break
            out.extend(nxt.tokens)
            node = nxt
        return out[:k]

    # -- mutation (the only sanctioned sites — NOS017) ------------------------
    def ensure_path(
        self, block_tokens: Sequence[Tuple[int, ...]], keys: Sequence[str]
    ) -> RadixNode:
        """Find-or-create the node chain for `block_tokens` (the prompt's
        full-block tuples, prefix order) with their chain `keys`. Missing
        ancestors are re-created as data-less nodes (an ancestor can be
        pruned between a slot's registration waves only if its canonical
        block was evicted without a tier meanwhile — the re-created node
        is exactly the tombstone that state deserves). Returns the final
        node. Creating a child bumps the parent's `_node_ref` (the
        'child refs' half of the node-refcount law)."""
        node = self._root
        for tokens, key in zip(block_tokens, keys):
            child = node._edges.get(tokens)
            if child is None:
                child = RadixNode(key, tuple(tokens), node)
                node._edges[tuple(tokens)] = child
                node._node_ref += 1
                self._nodes[key] = child
            node = child
        return node

    def insert_path(
        self, prompt: Sequence[int], block_size: int, n_blocks: int
    ) -> None:
        """`ensure_path` from raw tokens — the router-shadow form (the
        router has the prompt, not pre-cut tuples)."""
        blocks = [
            tuple(prompt[b * block_size : (b + 1) * block_size])
            for b in range(n_blocks)
        ]
        self.ensure_path(
            blocks,
            prompt_chain_keys(prompt, block_size, self.key_salt)[:n_blocks],
        )

    def ref(self, key: str) -> None:
        """A page table mapped the node's indexed block (admission hit,
        or a prefill/output registration by the owning slot)."""
        self._nodes[key]._node_ref += 1

    def unref(self, key: str, resident: Callable[[str], bool]) -> None:
        """A page table unmapped the node's block (slot release). Prunes
        the node — and cascading dead ancestors — when nothing refs it
        and no tier holds its data."""
        node = self._nodes.get(key)
        if node is None:
            return
        node._node_ref -= 1
        self._prune_up(node, resident)

    def note_nonresident(self, key: str, resident: Callable[[str], bool]) -> None:
        """The node's data left its last tier (tier-less eviction, host
        drop discovered at walk time): prune if nothing else holds it."""
        node = self._nodes.get(key)
        if node is not None:
            self._prune_up(node, resident)

    def _prune_up(self, node: RadixNode, resident: Callable[[str], bool]) -> None:
        while (
            node is not self._root
            and node._node_ref == 0
            and not node._edges
            and not resident(node.key)
        ):
            parent = node.parent
            del parent._edges[node.tokens]
            parent._node_ref -= 1
            del self._nodes[node.key]
            node = parent

    def sweep(self, resident: Callable[[str], bool]) -> None:
        """Post-order prune of every dead leaf chain (node_ref 0, no
        children, non-resident) — the amortized cleanup for residency
        lost WITHOUT a callback (host-tier LRU drops). Table refs are
        preserved; only genuinely dead structure goes."""

        def visit(node: RadixNode) -> None:
            for tokens in list(node._edges):
                child = node._edges[tokens]
                visit(child)
                if (
                    child._node_ref == 0
                    and not child._edges
                    and not resident(child.key)
                ):
                    del node._edges[tokens]
                    node._node_ref -= 1
                    del self._nodes[child.key]

        visit(self._root)

    def device_reset(self, host_resident: Callable[[str], bool]) -> None:
        """The device pool was reallocated (engine recovery): every page
        table is gone and every device block's content with it. Clear
        all table refs, keep exactly the nodes that are host-resident or
        ancestors of one (tombstones — the host walk needs the path),
        and rebase `_node_ref` to surviving-children counts."""

        def keep(node: RadixNode) -> bool:
            kept = {}
            for tokens, child in node._edges.items():
                if keep(child):
                    kept[tokens] = child
                else:
                    del self._nodes[child.key]
            node._edges = kept
            node._node_ref = len(kept)
            return bool(kept) or host_resident(node.key)

        kept_root = {}
        for tokens, child in self._root._edges.items():
            if keep(child):
                kept_root[tokens] = child
            else:
                del self._nodes[child.key]
        self._root._edges = kept_root
        self._root._node_ref = len(kept_root)

    def reset(self) -> None:
        """Forget everything (model/params swap — the tier-reset analog)."""
        self._root = RadixNode("", (), None)
        self._nodes = {}
