"""Block-paged KV arena for the continuous-batching runtime.

:class:`PagedKVCachePool` is the port of ``repro.runtime.kv_pool.
PagedKVCachePool``: one shared arena of fixed-size KV pages
(``model.make_paged_cache``) plus a per-slot page table on the host, with
the same accounting, so the same operation sequence gives the same page
tables, refcounts and free counts in both packages.

* Page 0 is the NULL page.  Free slots (which still ride in the shared
  decode batch at position 0), foreign slots in an owner's masked view and
  unmapped logical blocks point at it; writes there land on a page no
  request owns and reads are masked out by the per-slot length.
* Admission RESERVES the request's worst-case block count against the free
  pool and maps pages lazily (``ensure_len``), so decode never stalls on a
  page; ``budget_tokens``/``extend_budget`` make the reservation
  incremental under chunked prefill.
* Every page carries a refcount.  ``bake_prefix`` pins a prompt prefix as
  a :class:`PrefixHandle`; ``alloc(shared_prefix=..., reuse_len=r)``
  aliases its full pages (refcount++) and copies the trailing partial page
  once (copy-on-write); writes to a page with refcount > 1 raise.
* Owner tokens partition the slot space among engines sharing the arena;
  ``device_page_table(owner)`` masks co-tenants' rows to the null page.
* ``kv_dtype='int8'`` stores int8 values plus per-row float32
  ``<leaf>_scale`` arenas on the same page axis, quantized on write and
  dequantized on read, so page copies and refcounts cover scales too.

The arena lives on the model's device and is updated in place (JAX's
functional ``arena.at[...].set`` becomes an indexed write on the current
stream).

Under a sharding plan (the model's; ``plan=`` as in the JAX pool must be
that one) every rank's arena holds its local KV heads, fp and int8 with
its scales alike, and the pools' methods are device ops of the
tensor-parallel channel (``distributed.group.mirrored``): the controller's
call runs on every rank with the same arguments, and the channel checks
that it ended alike on every rank, so page tables, refcounts and free
lists are identical on every rank.

:class:`KVCachePool` is the dense slot pool (``repro.runtime.kv_pool.
KVCachePool``): one cache from ``model.make_cache(n_slots, max_len)``
whose batch axis (axis 1 of every leaf) is the slot axis, for the
sequential-reference and ``paged=False`` engines and for the families
whose state does not grow with the sequence (zamba: Mamba2 state plus
the shared attention's K/V); its decode runs the ``decode_attention``
kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.group import mirrored
from repro_torch.models import quant
from repro_torch.models.registry import Model
from repro_torch.runtime.errors import PartitionViolation, PoolExhausted
from repro_torch.utils import map_with_path, named_leaves, tree_bytes

__all__ = ["KVCachePool", "PoolExhausted", "PartitionViolation",
           "PrefixHandle", "PagedKVCachePool"]


@dataclasses.dataclass
class PrefixHandle:
    """A pinned, refcounted span of prompt-prefix KV pages.

    ``pages`` are physical arena pages in logical order; ``n_tokens`` may
    end mid-page (the trailing partial page is the copy-on-write unit).
    The handle holds one reference on every page until ``release_prefix``.
    ``tokens`` keeps the prefix token ids for exact-match verification.
    """

    pool: "PagedKVCachePool"
    pages: tuple
    n_tokens: int
    tokens: np.ndarray
    pinned: bool = True

    @property
    def page_size(self) -> int:
        """Tokens per page of the owning pool."""
        return self.pool.page_size

    @property
    def n_full_pages(self) -> int:
        """Pages the prefix fills completely (aliasable without a copy)."""
        return self.n_tokens // self.page_size


def _check_plan(model: Model, plan) -> None:
    """A pool's ``plan`` (the JAX signature's) must be its model's: the
    model's caches and arenas already hold the rank's KV heads.  No pool
    takes a sequence-sharded cache (a ``prefer_seq`` plan)."""
    if getattr(model, "seq_split", False):
        model.refuse_seq_split("a KV pool")
    if plan is not None and plan.tp > 1 and plan != model.plan:
        raise ValueError("the pool's plan must be its model's: build the "
                         "model under the plan (get_model(..., plan=plan))")


class KVCachePool:
    """Slot-indexed dense KV cache shared by one decode batch.

    The cache lives on the model's device; ``write_slot`` and
    ``read_slot`` copy a batch-1 cache of the same ``max_len`` into and out
    of a slot in place.  Free slots are handed out lowest first, as in the
    JAX pool, so the same operations give the same slots."""

    @mirrored(register=("self", "self.cache"))
    def __init__(self, model: Model, n_slots: int, max_len: int,
                 plan=None):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        _check_plan(model, plan)
        self.model = model
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache = model.make_cache(n_slots, max_len)
        self._free = list(range(n_slots - 1, -1, -1))
        self._free_set = set(self._free)

    # ---- slot bookkeeping -------------------------------------------------
    @property
    def n_free(self) -> int:
        """Slots currently unallocated."""
        return len(self._free)

    def mirror_digest(self) -> str:
        """Host state compared across ranks by the divergence guard."""
        return f"KVCachePool{self._free}"

    @mirrored()
    def alloc(self) -> int:
        """Claim a free slot; raises :class:`PoolExhausted` when none."""
        if not self._free:
            raise PoolExhausted("KVCachePool exhausted: no free slots")
        slot = self._free.pop()
        self._free_set.discard(slot)
        return slot

    @mirrored()
    def release(self, slot: int) -> None:
        """Return ``slot`` to the free list (double-release raises)."""
        if slot in self._free_set or not (0 <= slot < self.n_slots):
            raise ValueError(f"bad slot release: {slot}")
        self._free.append(slot)
        self._free_set.add(slot)

    # ---- cache movement ---------------------------------------------------
    @mirrored()
    def write_slot(self, slot: int, sub_cache: dict) -> None:
        """Copy a batch-1 cache (same ``max_len`` layout) into ``slot``.
        The cache may be nested (zamba: ``mamba.{h,conv}``,
        ``attn_kv.{k,v}``); axis 1 of every leaf is the slot axis."""
        sub = dict(named_leaves(sub_cache))
        for path, arena in named_leaves(self.cache):
            arena[:, slot] = sub[path][:, 0].to(arena.dtype)

    @mirrored(register=("return",))
    def read_slot(self, slot: int) -> dict:
        """``slot`` as a batch-1 cache (a copy)."""
        return map_with_path(lambda _, t: t[:, slot:slot + 1].clone(),
                             self.cache)

    def nbytes(self) -> int:
        """Total bytes of the pool's cache."""
        return tree_bytes(self.cache)


class PagedKVCachePool:
    """Block-paged KV arena + per-slot page tables (see the module doc).

    Allocatable pages are ``1 .. n_pages-1``.  The arena lives on the
    model's device.
    """

    NULL_PAGE = 0

    @mirrored(register=("self", "self.cache"))
    def __init__(self, model: Model, n_slots: int, max_len: int,
                 page_size: int = 8, n_pages: Optional[int] = None,
                 plan=None, kv_dtype: Optional[str] = None):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        _check_plan(model, plan)
        if not model.supports_paged_kv:
            raise ValueError(
                f"{model.cfg.name}: family {model.cfg.family!r} has no "
                "paged KV layout")
        self.model = model
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_size = page_size
        self.kv_dtype = kv_dtype
        self.blocks_per_slot = -(-max_len // page_size)
        # logical span of a full slot (page multiple)
        self.padded_len = self.blocks_per_slot * page_size
        if n_pages is None:
            # capacity-equal to a dense pool: every slot can grow to max_len
            n_pages = 1 + n_slots * self.blocks_per_slot
        if n_pages < 2:
            raise ValueError("n_pages must be >= 2 (null page + 1)")
        self.n_pages = n_pages
        self.cache = model.make_paged_cache(n_pages, page_size,
                                            kv_dtype=kv_dtype)
        # the fp dtype prefill produces and read_slot* hands back
        self._fp_dtype = model.dtype
        self.page_table = np.zeros((n_slots, self.blocks_per_slot), np.int32)
        self._free_slots = list(range(n_slots - 1, -1, -1))
        self._free_slot_set = set(self._free_slots)
        self._free_pages = list(range(n_pages - 1, 0, -1))
        self._reserved = 0                 # reserved-but-unmapped blocks
        self._mapped: dict[int, int] = {}  # slot -> mapped block count
        self._budget: dict[int, int] = {}  # slot -> reserved block total
        self._page_refs = np.zeros(n_pages, np.int32)
        self._next_owner = 0
        self._owners: dict[int, Optional[str]] = {}
        self._slot_owner: dict[int, int] = {}
        self._owner_pts: dict[int, torch.Tensor] = {}
        self._owner_dirty: dict[int, set] = {}
        self.stats = {"fresh_pages_mapped": 0, "shared_pages_mapped": 0,
                      "cow_page_copies": 0}
        self.peak_used_pages = 0           # high-water resident footprint
        # device-resident page table, synced by dirty row
        self._device_pt: Optional[torch.Tensor] = None
        self._dirty_rows: set = set()

    def mirror_digest(self) -> str:
        """Host state compared across ranks by the divergence guard: the
        page table, refcounts, free lists and reservations."""
        return repr((self.page_table.tolist(), self._page_refs.tolist(),
                     self._free_pages, self._free_slots, self._reserved,
                     sorted(self._mapped.items()),
                     sorted(self._budget.items()),
                     sorted(self._slot_owner.items())))

    # ---- accounting -------------------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        """Pages needed to back ``n_tokens`` positions (minimum 1)."""
        return max(1, -(-n_tokens // self.page_size))

    @property
    def n_free_slots(self) -> int:
        """Slots currently unallocated."""
        return len(self._free_slots)

    @property
    def n_free_pages(self) -> int:
        """Pages on the free list (some may be promised to reservations)."""
        return len(self._free_pages)

    @property
    def n_available_pages(self) -> int:
        """Pages neither mapped nor promised to an admitted request."""
        return len(self._free_pages) - self._reserved

    def can_admit(self, n_tokens_total: int, reuse_len: int = 0) -> bool:
        """True when a request of this total length is admissible now."""
        fresh = self.blocks_for(n_tokens_total) - reuse_len // self.page_size
        return bool(self._free_slots) and fresh <= self.n_available_pages

    # ---- slot partitions (multi-tenancy) ----------------------------------
    @mirrored()
    def register_owner(self, name: Optional[str] = None) -> int:
        """Mint an owner token partitioning the slot space."""
        self._next_owner += 1
        token = self._next_owner
        self._owners[token] = name
        self._owner_dirty[token] = set()
        return token

    @mirrored()
    def release_owner(self, owner: int) -> None:
        """Drop an owner token, releasing any slots it still holds."""
        if owner not in self._owners:
            raise ValueError(f"unknown owner token {owner}")
        for slot in [s for s, o in self._slot_owner.items() if o == owner]:
            self.release(slot, owner=owner)
        del self._owners[owner]
        self._owner_pts.pop(owner, None)
        self._owner_dirty.pop(owner, None)

    def slot_owner(self, slot: int) -> Optional[int]:
        """Owner token holding ``slot`` (None: free or unowned)."""
        return self._slot_owner.get(slot)

    def owner_slots(self, owner: int) -> list:
        """Slots currently allocated under ``owner`` (sorted)."""
        return sorted(s for s, o in self._slot_owner.items() if o == owner)

    def n_foreign_slots(self, owner: Optional[int]) -> int:
        """Allocated slots NOT held by ``owner`` (co-tenant occupancy)."""
        n_held = self.n_slots - len(self._free_slots)
        if owner is None:
            return n_held - sum(
                1 for s in range(self.n_slots)
                if s not in self._free_slot_set
                and self._slot_owner.get(s) is None)
        return n_held - len(self.owner_slots(owner))

    def partition_stats(self, owner: int) -> dict:
        """Resident footprint of one owner's slot partition."""
        if owner not in self._owners:
            raise ValueError(f"unknown owner token {owner}")
        slots = self.owner_slots(owner)
        mapped = sum(self._mapped[s] for s in slots)
        budget = sum(self._budget[s] for s in slots)
        return {"owner": owner, "name": self._owners[owner],
                "n_slots": len(slots), "mapped_pages": mapped,
                "reserved_pages": budget - mapped}

    def _check_owner(self, slot: int, owner: Optional[int], verb: str) -> None:
        """Raise when ``owner`` tries to touch a slot it does not hold."""
        if owner is None:
            return
        held_by = self._slot_owner.get(slot)
        if held_by != owner:
            whose = (f"partition {held_by} ({self._owners.get(held_by)!r})"
                     if held_by is not None else "no partition")
            raise PartitionViolation(
                f"slot {slot}: owner {owner} ({self._owners.get(owner)!r}) "
                f"may not {verb} a slot held by {whose}")

    # ---- alloc / grow / release ------------------------------------------
    @mirrored()
    def alloc(self, prompt_len: int, max_new_tokens: int,
              shared_prefix: Optional[PrefixHandle] = None,
              reuse_len: int = 0, budget_tokens: Optional[int] = None,
              owner: Optional[int] = None) -> int:
        """Claim a slot and reserve the request's worst-case block count.

        With ``shared_prefix``, the first ``reuse_len`` prompt tokens are
        served from the handle's pages: full pages alias (refcount++), a
        trailing partial page is copied once into a page the slot owns
        (values and scales alike).  ``budget_tokens`` caps the initial
        reservation (chunked prefill grows it with :meth:`extend_budget`).
        ``owner`` files the slot under a partition token.
        """
        if owner is not None and owner not in self._owners:
            raise ValueError(f"unknown owner token {owner}")
        total = self.blocks_for(prompt_len + max_new_tokens)
        if total > self.blocks_per_slot:
            raise ValueError(
                f"request needs {total} pages but a slot's page table "
                f"holds {self.blocks_per_slot} (max_len={self.max_len})")
        if total > self.n_pages - 1:
            raise ValueError(
                f"request needs {total} pages but the arena only has "
                f"{self.n_pages - 1} allocatable pages")
        n_full = 0
        if shared_prefix is not None and reuse_len > 0:
            if shared_prefix.pool is not self:
                raise ValueError("shared_prefix belongs to another pool")
            if not shared_prefix.pinned:
                raise ValueError("shared_prefix has been released")
            if reuse_len > shared_prefix.n_tokens:
                raise ValueError(
                    f"reuse_len={reuse_len} exceeds the prefix's "
                    f"{shared_prefix.n_tokens} cached tokens")
            if reuse_len >= prompt_len:
                raise ValueError(
                    "reuse_len must leave at least one prompt token to "
                    "prefill (the suffix produces the first logits)")
            n_full = reuse_len // self.page_size
        partial = (shared_prefix is not None and reuse_len > 0
                   and reuse_len % self.page_size != 0)
        budget = total
        if budget_tokens is not None:
            if budget_tokens <= reuse_len:
                raise ValueError(
                    f"budget_tokens={budget_tokens} must cover the reused "
                    f"prefix ({reuse_len} tokens) plus at least one more")
            budget = min(total, self.blocks_for(budget_tokens))
        fresh = budget - n_full             # incl. the COW partial page
        if not self._free_slots:
            raise PoolExhausted("PagedKVCachePool exhausted: no free slots")
        if fresh > self.n_available_pages:
            raise PoolExhausted(
                f"PagedKVCachePool exhausted: need {fresh} fresh pages, "
                f"{self.n_available_pages} available")
        slot = self._free_slots.pop()
        self._free_slot_set.discard(slot)
        if owner is not None:
            self._slot_owner[slot] = owner
        mapped = 0
        if n_full:
            share = [int(p) for p in shared_prefix.pages[:n_full]]
            self.page_table[slot, :n_full] = share
            self._page_refs[share] += 1
            mapped = n_full
            self.stats["shared_pages_mapped"] += n_full
        if partial:
            page = self._claim_free_page()
            donor = int(shared_prefix.pages[n_full])
            for arena in self.cache.values():
                arena[:, page] = arena[:, donor]      # in-place page copy
            self.page_table[slot, mapped] = page
            mapped += 1
            self.stats["cow_page_copies"] += 1
        self._reserved += budget - mapped
        self._budget[slot] = budget
        self._mapped[slot] = mapped
        if mapped:
            self._touch(slot)
        return slot

    @mirrored()
    def extend_budget(self, slot: int, n_tokens: int,
                      owner: Optional[int] = None) -> bool:
        """Grow ``slot``'s reserved block budget to cover ``n_tokens``.

        Returns False, with no state change, when the free pool cannot
        back the extra reservation right now.
        """
        if slot not in self._budget:
            raise ValueError(f"slot {slot} is not allocated")
        self._check_owner(slot, owner, "grow the budget of")
        need = self.blocks_for(n_tokens)
        if need > self.blocks_per_slot:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens needs {need} pages but a "
                f"slot's page table holds {self.blocks_per_slot}")
        extra = need - self._budget[slot]
        if extra <= 0:
            return True
        if extra > self.n_available_pages:
            return False
        self._budget[slot] = need
        self._reserved += extra
        return True

    def slot_budget(self, slot: int) -> int:
        """Currently reserved block budget of an allocated slot."""
        return self._budget[slot]

    @mirrored()
    def ensure_len(self, slot: int, n_tokens: int,
                   owner: Optional[int] = None) -> None:
        """Map pages so positions ``0 .. n_tokens-1`` are backed."""
        if slot not in self._budget:
            raise ValueError(f"slot {slot} is not allocated")
        self._check_owner(slot, owner, "map pages into")
        need = self.blocks_for(n_tokens)
        if need > self._budget[slot]:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens exceeds the reserved "
                f"budget of {self._budget[slot]} pages")
        while self._mapped[slot] < need:
            if not self._free_pages:        # unreachable within budget
                raise PoolExhausted("PagedKVCachePool: free list empty")
            page = self._claim_free_page()
            self.page_table[slot, self._mapped[slot]] = page
            self._mapped[slot] += 1
            self._reserved -= 1
            self._touch(slot)

    def _claim_free_page(self) -> int:
        """Pop a free page at refcount 1, tracking counters + peak."""
        page = self._free_pages.pop()
        self._page_refs[page] = 1
        self.stats["fresh_pages_mapped"] += 1
        self.peak_used_pages = max(self.peak_used_pages, self.n_used_pages)
        return page

    def _unref_page(self, page: int) -> None:
        self._page_refs[page] -= 1
        if self._page_refs[page] == 0:
            self._free_pages.append(page)
        elif self._page_refs[page] < 0:
            raise AssertionError(f"page {page} refcount went negative")

    @mirrored()
    def release(self, slot: int, owner: Optional[int] = None) -> None:
        """Retire ``slot``: unref its mapped pages and free the slot."""
        if slot in self._free_slot_set or not (0 <= slot < self.n_slots):
            raise ValueError(f"bad slot release: {slot}")
        self._check_owner(slot, owner, "release")
        self._slot_owner.pop(slot, None)
        mapped = self._mapped.pop(slot)
        budget = self._budget.pop(slot)
        for p in self.page_table[slot, :mapped]:
            self._unref_page(int(p))
        self._reserved -= budget - mapped
        self.page_table[slot, :] = self.NULL_PAGE
        self._free_slots.append(slot)
        self._free_slot_set.add(slot)
        self._touch(slot)

    # ---- prefix sharing ---------------------------------------------------
    @mirrored(register=("return",))
    def bake_prefix(self, sub_cache: dict, tokens) -> PrefixHandle:
        """Materialize a prompt prefix as pinned shared pages.

        ``sub_cache`` is a batch-1 prefilled dense cache covering
        ``tokens`` (leaves ``[L, 1, T, ...]``, ``T`` a page multiple).
        """
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n_tokens = len(tokens)
        if n_tokens < 1:
            raise ValueError("a prefix needs at least one token")
        nb = self.blocks_for(n_tokens)
        if nb > self.n_available_pages:
            raise PoolExhausted(
                f"PagedKVCachePool exhausted: prefix needs {nb} pages, "
                f"{self.n_available_pages} available")
        pages = [self._claim_free_page() for _ in range(nb)]
        self._write_blocks(pages, sub_cache, first_block=0)
        return PrefixHandle(pool=self, pages=tuple(pages),
                            n_tokens=n_tokens, tokens=tokens)

    @mirrored()
    def release_prefix(self, handle: PrefixHandle) -> None:
        """Drop the handle's pin; pages free as their refcount hits 0."""
        if not handle.pinned or handle.pool is not self:
            raise ValueError("handle is not pinned on this pool")
        handle.pinned = False
        for p in handle.pages:
            self._unref_page(int(p))

    def prefix_page_refs(self, handle: PrefixHandle) -> list:
        """Current refcounts of the handle's pages (test/debug surface)."""
        return [int(self._page_refs[p]) for p in handle.pages]

    # ---- cache movement ---------------------------------------------------
    def _write_blocks(self, pages, sub_cache: dict, first_block: int) -> None:
        """Scatter logical blocks of a batch-1 dense fp cache into pages
        (quantizing each row in int8 mode), in place."""
        ps = self.page_size
        idx = torch.as_tensor(np.asarray(pages, np.int64), device=self.device)

        def span(sub):
            L, _, T = sub.shape[:3]
            blocks = sub[:, 0].reshape((L, T // ps, ps) + tuple(sub.shape[3:]))
            return blocks[:, first_block:first_block + len(pages)]

        for key, sub in sub_cache.items():
            if self.kv_dtype is None:
                self.cache[key][:, idx] = span(sub).to(self.cache[key].dtype)
            else:
                q, s = quant.quantize_rows(span(sub))
                self.cache[key][:, idx] = q
                self.cache[key + quant.SCALE_SUFFIX][:, idx] = s

    @mirrored()
    def write_prompt(self, slot: int, sub_cache: dict, n_tokens: int,
                     owner: Optional[int] = None) -> None:
        """Write a prefilled prompt into ``slot``'s pages (allocating them)."""
        self.write_suffix(slot, sub_cache, 0, n_tokens, owner=owner)

    @mirrored()
    def write_suffix(self, slot: int, sub_cache: dict, start_token: int,
                     n_tokens: int, owner: Optional[int] = None) -> None:
        """Write positions ``start_token .. n_tokens-1`` into ``slot``.

        Maps missing pages, then writes whole blocks from ``start_token //
        page_size`` on; writing a shared (aliased) page raises.
        """
        self._check_owner(slot, owner, "write KV into")
        self.ensure_len(slot, n_tokens, owner=owner)
        first = start_token // self.page_size
        nb = self.blocks_for(n_tokens)
        if first >= nb:
            return
        pages = self.page_table[slot, first:nb]
        shared = [int(p) for p in pages if self._page_refs[int(p)] > 1]
        if shared:
            raise ValueError(
                f"slot {slot}: refusing to write shared pages {shared} "
                "(aliased prefix pages are copy-on-write)")
        self._write_blocks(pages, sub_cache, first_block=first)

    def _gather_pages(self, pages, length: int) -> dict:
        """Gather ``pages`` into a batch-1 dense fp cache of ``length``."""
        idx = torch.as_tensor(np.asarray(pages, np.int64), device=self.device)

        def gather(arena):
            blocks = arena[:, idx]                     # [L, nb, ps, ...]
            return blocks.reshape((blocks.shape[0], 1, length)
                                  + tuple(blocks.shape[3:]))

        if self.kv_dtype is None:
            return {k: gather(a) for k, a in self.cache.items()}
        return {key: quant.dequantize_rows(
                    gather(self.cache[key]),
                    gather(self.cache[key + quant.SCALE_SUFFIX]),
                    self._fp_dtype)
                for key in quant.value_keys(self.cache)}

    @mirrored(register=("return",))
    def read_slot(self, slot: int, n_tokens: int) -> dict:
        """Gather ``slot``'s first ``n_tokens`` positions as a dense fp
        cache of page-multiple length."""
        nb = self.blocks_for(n_tokens)
        return self._gather_pages(self.page_table[slot, :nb],
                                  nb * self.page_size)

    @mirrored(register=("return",))
    def read_slot_full(self, slot: int) -> dict:
        """Gather the slot's whole page-table row (``padded_len``
        positions) as the suffix-prefill working cache."""
        return self._gather_pages(self.page_table[slot], self.padded_len)

    # ---- device page table (dirty-row sync) -------------------------------
    def _touch(self, slot: int) -> None:
        self._dirty_rows.add(slot)
        for dirty in self._owner_dirty.values():
            dirty.add(slot)

    def _masked_rows(self, owner: int, rows) -> np.ndarray:
        """Host page-table rows with co-tenants' slots forced to NULL."""
        out = np.zeros((len(rows), self.blocks_per_slot), np.int32)
        for i, slot in enumerate(rows):
            if self._slot_owner.get(slot) == owner:
                out[i] = self.page_table[slot]
        return out

    def host_page_table(self, owner: Optional[int] = None) -> np.ndarray:
        """The page table as host int32 rows (with ``owner``, its masked
        view): what a tensor-parallel decode step sends every rank, each
        uploading it to its own device."""
        if owner is None:
            return self.page_table.copy()
        if owner not in self._owners:
            raise ValueError(f"unknown owner token {owner}")
        return self._masked_rows(owner, range(self.n_slots))

    def device_page_table(self, owner: Optional[int] = None) -> torch.Tensor:
        """The page table as an int32 tensor on the pool's device.

        Only rows changed since the last call are uploaded.  With
        ``owner``, the table is that partition's masked view: rows of
        slots held by any other owner read as all-NULL.
        """
        if owner is None:
            if self._device_pt is None:
                self._device_pt = self._upload(self.page_table)
                self._dirty_rows.clear()
            elif self._dirty_rows:
                rows = sorted(self._dirty_rows)
                self._device_pt = self._upload_rows(
                    self._device_pt, rows, self.page_table[rows])
                self._dirty_rows.clear()
            return self._device_pt
        if owner not in self._owners:
            raise ValueError(f"unknown owner token {owner}")
        dirty = self._owner_dirty[owner]
        if owner not in self._owner_pts:
            self._owner_pts[owner] = self._upload(
                self._masked_rows(owner, range(self.n_slots)))
            dirty.clear()
        elif dirty:
            rows = sorted(dirty)
            self._owner_pts[owner] = self._upload_rows(
                self._owner_pts[owner], rows, self._masked_rows(owner, rows))
            dirty.clear()
        return self._owner_pts[owner]

    def _upload(self, table: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(table), device=self.device)

    def _upload_rows(self, device_pt, rows, host_rows) -> torch.Tensor:
        # a new tensor, not an in-place edit: a caller may still hold the
        # previous table (the same contract as the JAX array it mirrors)
        out = device_pt.clone()
        out[torch.as_tensor(rows, device=self.device)] = self._upload(host_rows)
        return out

    # ---- footprint --------------------------------------------------------
    @property
    def n_used_pages(self) -> int:
        """Pages currently holding KV (mapped by slots or pinned)."""
        return (self.n_pages - 1) - len(self._free_pages)

    def page_nbytes(self) -> int:
        """Bytes per page (scale rows included in quantized mode)."""
        return self.nbytes() // self.n_pages

    def resident_nbytes(self) -> int:
        """Bytes of the pages currently holding KV."""
        return self.n_used_pages * self.page_nbytes()

    def nbytes(self) -> int:
        """Total bytes of the arena (value + scale leaves)."""
        return sum(t.numel() * t.element_size() for t in self.cache.values())
