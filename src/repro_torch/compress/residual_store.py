"""Bounded per-client pipeline state: the LRU slab and its count-sketch
tail (port of ``repro.compress.residual_store``).

A dense ``comm_state`` keeps one row per client, which caps a simulated
population at a few thousand clients.  The store keeps ``capacity`` slots
plus an id -> slot map instead:

  * ``gather(state, ids)``, at dispatch: resident ids read their slot;
    absent ids read zeros (``eviction="drop"``) or their estimate from the
    count-sketch tail (``eviction="sketch"``), scaled by the projection of
    the tail onto the estimate's own sketch and moved out of the tail
    (energy-conserving recovery: the recover -> EF -> re-fold cycle
    contracts).
  * ``scatter(state, ids, rows)``, at commit: resident ids reuse their
    slot; new ids take free slots first, then the least recently committed
    ones, whose rows fold into the tail under ``"sketch"``.

With ``capacity >= C`` and every client first touched in id order, slot i
holds client i, nothing is evicted, and gather/scatter are the identity:
the population path is then bit-exact with the dense one.

The state is a plain dict:

    {"slab":   tuple over param leaves of pipeline-state pytrees, every
               tensor (capacity,)-led,
     "client": (capacity,) int32 resident client id (-1 = free),
     "stamp":  (capacity,) int32 last-commit clock,
     "clock":  () int32,
     "tail":   ["sketch" only] tuple over param leaves of (tail_rows,
               tail_cols) f32 sketches per float state tensor, a (0,)
               placeholder for any other tensor}

The tail hashes the global coordinate ``id * n + j`` of element j of a
client's n-element row, which the reference computes in uint32.  The port
computes it in int64 and ``compress.sketch.bucket_and_sign`` reduces it
mod 2^32, so ids whose ``id * n`` passes 2^32 hash as in the reference.
Each client's row is hashed on its own and in ``compress.sketch.CHUNK``
pieces, and at most one evicted row is read at a time, so an llama-sized
leaf never materialises an (M, rows, n) index.
"""
from __future__ import annotations

import torch

from repro_torch.compress import sketch as _sk
from repro_torch.device import resolve_device

EVICTION_POLICIES = ("drop", "sketch")
_FREE = -(2 ** 31)                     # sort key: free slots first
_HIT = 2 ** 31 - 1                     # sort key: never evict a hit slot


def _leaves(tree) -> list:
    """Tensors of a state pytree in ``jax.tree.leaves`` order (dict keys
    sorted, tuples in order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _map(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` (and the same places of
    ``rest``), keeping the structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return tree


def _unflatten(tree, leaves):
    """``tree``'s structure with its tensors replaced, in ``_leaves``
    order, by ``leaves``."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            done = {k: walk(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return node
    return walk(tree)


def store_nbytes(state) -> int:
    """Byte footprint of a store state (or any comm_state pytree): the
    quantity that stays flat in the population size."""
    return int(sum(t.numel() * t.element_size() for t in _leaves(state)))


class ResidualStore:
    """Store ops for one (pipeline, params, capacity) binding.  ``ids``
    must be unique within a call (cohort sampling guarantees it)."""

    def __init__(self, pipe, params, capacity: int, eviction: str = "drop",
                 tail_rows: int = 5, tail_cols: int = 16384,
                 tail_seed: int = 23, device=None):
        if eviction not in EVICTION_POLICIES:
            raise ValueError(f"eviction must be one of {EVICTION_POLICIES}; "
                             f"got {eviction!r}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = int(capacity)
        self.eviction = eviction
        self.tail_rows = int(tail_rows)
        self.tail_cols = int(tail_cols)
        self.tail_seed = int(tail_seed)
        self.device = resolve_device(device)
        # where each hash row's buckets start in a flat row sketch
        self._row_offsets = torch.arange(
            self.tail_rows, device=self.device)[:, None] * self.tail_cols
        # the slab's row layout: per param leaf, the pipeline's state
        # pytree on the meta device (``params`` maps names to anything
        # with a ``shape``)
        self.templates = tuple(pipe.init(tuple(p.shape), device="meta")
                               for p in params.values())

    # ------------------------------------------------------------------ init
    def init(self) -> dict:
        S, dev = self.capacity, self.device
        state = {
            "slab": tuple(_map(lambda a: torch.zeros((S,) + tuple(a.shape),
                                                     dtype=a.dtype,
                                                     device=dev), t)
                          for t in self.templates),
            "client": torch.full((S,), -1, dtype=torch.int32, device=dev),
            "stamp": torch.zeros((S,), dtype=torch.int32, device=dev),
            "clock": torch.zeros((), dtype=torch.int32, device=dev),
        }
        if self.eviction == "sketch":
            state["tail"] = tuple(
                _map(lambda a: torch.zeros(
                    (self.tail_rows, self.tail_cols)
                    if a.dtype.is_floating_point else (0,),
                    dtype=torch.float32, device=dev), t)
                for t in self.templates)
        return state

    # ---------------------------------------------------------------- lookup
    @staticmethod
    def _match(state, ids):
        """(found (M,), slot (M,), eq (M, S)); slot is garbage where not
        found and stays masked."""
        eq = ids[:, None] == state["client"][None, :]
        # argmax takes the first maximum, as jnp.argmax over a bool array
        return eq.any(dim=1), eq.to(torch.int32).argmax(dim=1), eq

    def _assign_slots(self, state, ids):
        """(found (M,), slot (M,)): hits reuse their slot, misses take free
        slots first, then the least recently committed occupied ones (the
        scatter's assignment, which ``stats`` previews)."""
        S = self.capacity
        client, stamp = state["client"], state["stamp"]
        found, hit_slot, eq = self._match(state, ids)
        hit_slots = eq.any(dim=0)
        key = torch.where(hit_slots, _HIT,
                          torch.where(client < 0, _FREE, stamp)) \
            .to(torch.int32)
        order = torch.sort(key, stable=True).indices  # free, LRU, hits last
        rank = torch.cumsum((~found).to(torch.int32), dim=0) - 1
        slot = torch.where(found, hit_slot, order[rank.clamp(0, S - 1)])
        return found, slot

    def stats(self, state, ids):
        """Counters for one gather/scatter cycle over ``ids``: ``hits`` and
        ``misses`` of the gather, the ``evictions`` the following scatter
        makes (misses landing on occupied slots), and ``sketch_recovered``
        (every miss under ``sketch``, 0 under ``drop``); f32 scalars."""
        found, slot = self._assign_slots(state, ids)
        miss = (~found).sum().to(torch.float32)
        evict = (~found) & (state["client"][slot] >= 0)
        return {"hits": found.sum().to(torch.float32), "misses": miss,
                "evictions": evict.sum().to(torch.float32),
                "sketch_recovered": (miss if self.eviction == "sketch"
                                     else torch.zeros_like(miss))}

    # ------------------------------------------------------------- tail hash
    def _coords(self, i: int, n: int, lo: int, hi: int):
        """Global flat coordinates ``i * n + j`` for j in [lo, hi), int64
        (``bucket_and_sign`` reduces them mod 2^32, the reference's uint32
        wrap)."""
        return i * n + torch.arange(lo, hi, dtype=torch.int64,
                                    device=self.device)

    def _tail_add(self, tail, rows, seed: int):
        """``tail`` plus the sketch of each client row of ``rows``, a list
        of (id, flat row (n,)): each row's sketch on its own, summed over
        the rows in order, then added to the tail (the reference's
        per-client sketch, sum over clients, add).  A row is read in f32
        one chunk at a time."""
        if not rows:
            return tail
        a, b = _sk.hash_params(self.tail_rows, seed)
        total = None
        for i, v in rows:
            n = v.shape[0]
            S = self._new_row_sketch()
            for lo, hi in _sk._chunks(n):
                h, s = _sk.bucket_and_sign(self._coords(i, n, lo, hi), a, b,
                                           self.tail_cols)
                self._fold(S, h, s, v[lo:hi].to(torch.float32))
            total = S if total is None else total + S
        return tail + total.reshape(tail.shape)

    def _new_row_sketch(self):
        return torch.zeros(self.tail_rows * self.tail_cols,
                           dtype=torch.float32, device=self.device)

    def _fold(self, S, h, s, x):
        """Adds the sketch of one chunk ``x`` (hashed to ``h``, ``s``) into
        the flat row sketch ``S``."""
        S.index_add_(0, (h + self._row_offsets).reshape(-1),
                     (s * x[None, :]).reshape(-1))

    def _tail_floor(self, tail):
        """The estimate's 4-sigma floor: a count-sketch estimate carries
        about sqrt(||tail||^2 / cols) of collision noise per coordinate,
        and coordinates below 4 times that estimate to 0."""
        return 4.0 * torch.sqrt((tail ** 2).sum(dim=1).mean()
                                / self.tail_cols)

    def _tail_estimate(self, tail, i: int, out, seed: int, floor):
        """Writes into ``out`` (n,) the median-of-rows estimate of client
        ``i``'s row from the tail, zero where it is not above ``floor``,
        and returns the estimate's own flat sketch (what ``_tail_add``
        would fold for it), from the same hash of each chunk."""
        a, b = _sk.hash_params(self.tail_rows, seed)
        n = out.shape[0]
        S = self._new_row_sketch()
        for lo, hi in _sk._chunks(n):
            h, s = _sk.bucket_and_sign(self._coords(i, n, lo, hi), a, b,
                                       self.tail_cols)
            med = _sk._midpoint_median(s * torch.gather(tail, 1, h))
            est = torch.where(med.abs() > floor, med, 0.0)
            out[lo:hi] = est
            self._fold(S, h, s, est)
        return S

    def _tail_arrays(self, state):
        """(leaf index, state-tensor index, slab tensor, tail sketch,
        per-tensor seed) for every state tensor, in ``_leaves`` order."""
        out = []
        for li, (slab_l, tail_l) in enumerate(zip(state["slab"],
                                                  state["tail"])):
            for ai, (sa, ta) in enumerate(zip(_leaves(slab_l),
                                              _leaves(tail_l))):
                out.append((li, ai, sa, ta,
                            self.tail_seed + 101 * li + 7 * ai))
        return out

    # ---------------------------------------------------------------- gather
    def gather(self, state, ids):
        """Rows for ``ids`` (M,), with an (M,) lead on every tensor:
        resident ids read their slot, absent ids zeros (drop) or the tail
        estimate (sketch, which moves it out of the tail).  Returns
        ``(rows, state)``; the state changes only under ``sketch``."""
        found, slot, _ = self._match(state, ids)

        def take(a):
            rows = a[slot]
            keep = found.reshape((-1,) + (1,) * (rows.ndim - 1))
            return torch.where(keep, rows, torch.zeros_like(rows))

        rows = tuple(_map(take, slab_l) for slab_l in state["slab"])
        if self.eviction != "sketch":
            return rows, state

        # The reference estimates every id and masks the estimate to the
        # misses (est * miss); a hit's masked estimate is +-0 in every
        # element, which adds nothing to its row (x + -0 = x) nor to the
        # sketch of the estimates (+0 + -0 = +0).  Walking the misses only
        # is therefore bit-identical.
        misses = [(m, i) for m, (i, f) in
                  enumerate(zip(ids.tolist(), found.tolist())) if not f]
        rows_l = [_leaves(r) for r in rows]
        new_tails = {}
        for li, ai, _sa, ta, seed in self._tail_arrays(state):
            if not ta.numel() or not misses:
                continue
            r_arr = rows_l[li][ai]
            flat = r_arr.reshape(r_arr.shape[0], -1)       # a view: fresh
            floor = self._tail_floor(ta)
            # a miss's gathered row is +0: its estimate is written there,
            # and the estimates' sketches summed in id order (index_add_
            # into +0 never yields -0, so this is the reference's
            # 0 + sum of sketches)
            sk = None
            for m, i in misses:
                S = self._tail_estimate(ta, i, flat[m], seed, floor)
                sk = S if sk is None else sk + S
            sk = sk.reshape(ta.shape)
            # energy-conserving recovery: hand out gamma * est, gamma the
            # projection of the tail onto sketch(est), clipped to [0, 1]
            gamma = torch.clamp((ta * sk).sum() / ((sk * sk).sum() + 1e-12),
                                0.0, 1.0)
            for m, _ in misses:
                # the reference's row, +0 + gamma * est (a -0 becomes +0)
                flat[m].mul_(gamma).add_(0.0)
            new_tails[li, ai] = ta - gamma * sk
        return rows, dict(state, tail=self._rebuild_tail(state, new_tails))

    @staticmethod
    def _rebuild_tail(state, updates: dict):
        return tuple(_unflatten(tail_l, [updates.get((li, ai), t)
                                         for ai, t in enumerate(
                                             _leaves(tail_l))])
                     for li, tail_l in enumerate(state["tail"]))

    # --------------------------------------------------------------- scatter
    def scatter(self, state, ids, rows):
        """Commit the cohort's rows: hits reuse their slot, misses take
        free slots, then the least recently committed ones; the evicted
        occupants' rows fold into the tail under ``sketch`` and are dropped
        under ``drop``.  Needs ``capacity >= len(ids)``."""
        S, M = self.capacity, ids.shape[0]
        if M > S:
            raise ValueError(f"cohort of {M} ids exceeds store capacity {S}")
        client, stamp = state["client"], state["stamp"]
        found, slot = self._assign_slots(state, ids)

        new_state = dict(state)
        if self.eviction == "sketch":
            old_ids = client[slot]
            # only evicted rows fold in (the reference masks the others to
            # zero rows, which add nothing); one row is read at a time
            evicted = [(int(s), o) for s, o, f in
                       zip(slot.tolist(), old_ids.tolist(), found.tolist())
                       if not f and o >= 0]
            new_tails = {}
            for li, ai, sa, ta, seed in self._tail_arrays(state):
                if ta.numel() and evicted:
                    new_tails[li, ai] = self._tail_add(
                        ta, [(o, sa[s].reshape(-1)) for s, o in evicted],
                        seed)
            new_state["tail"] = self._rebuild_tail(state, new_tails)

        def put(a, r):
            return a.index_copy(0, slot, r.to(a.dtype))

        new_state["slab"] = tuple(_map(put, slab_l, rows_l)
                                  for slab_l, rows_l in zip(state["slab"],
                                                            rows))
        new_state["client"] = client.index_copy(0, slot,
                                                ids.to(torch.int32))
        new_state["stamp"] = stamp.index_copy(0, slot,
                                              state["clock"].expand(M))
        new_state["clock"] = state["clock"] + 1
        return new_state

