"""Prefix matching for copy-on-write prompt-KV reuse.

:class:`PrefixIndex` maps incoming prompts to cached
:class:`~repro_torch.runtime.kv_pool.PrefixHandle` spans.  Lookup is a
page-granular token-hash CHAIN: for every registered prefix, page ``k``
contributes ``h_k = hash(h_{k-1}, tokens[k*ps:(k+1)*ps])`` and the index
stores ``(k, h_k) -> handle``.  Matching walks the incoming prompt's own
chain until it falls off the index — O(pages of the hit), independent of
how many prefixes are registered — then verifies the nominated handle by
EXACT token comparison (hashes only nominate; they never authorize reuse),
which also extends the hit into the handle's trailing partial page.

The reuse length is always capped at ``len(prompt) - 1``: at least one
prompt token must prefill so the request produces its first-token logits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.runtime.kv_pool import PrefixHandle


class PrefixIndex:
    """Page-granular chained-hash index over registered prompt prefixes."""

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = page_size
        self._chains: dict = {}          # (depth, chain_hash) -> handle
        self._handles: list = []

    def __len__(self) -> int:
        return len(self._handles)

    def _chain(self, tokens: np.ndarray, max_pages: Optional[int] = None):
        """Chained page hashes h_1..h_k of ``tokens``'s full pages."""
        ps = self.page_size
        n = len(tokens) // ps
        if max_pages is not None:
            n = min(n, max_pages)
        out, h = [], 0
        for k in range(n):
            h = hash((h, tokens[k * ps:(k + 1) * ps].tobytes()))
            out.append(h)
        return out

    def register(self, handle: PrefixHandle) -> None:
        """Index a baked prefix.  Prefixes shorter than one page are kept
        (exact matching still finds them through deeper registrations'
        shared chains only), but a handle needs at least one full page to
        be discoverable on its own."""
        if handle.page_size != self.page_size:
            raise ValueError(
                f"handle page_size={handle.page_size} != index "
                f"page_size={self.page_size}")
        tokens = np.asarray(handle.tokens, np.int32)
        for depth, h in enumerate(self._chain(tokens), start=1):
            # first registration wins a contested chain position; deeper
            # positions are unique to the longer prefix anyway
            self._chains.setdefault((depth, h), handle)
        self._handles.append(handle)

    def unregister(self, handle: PrefixHandle) -> None:
        """Forget a handle, REBUILDING the chain map from the survivors:
        a chain position the departing handle owned may be shared leading
        pages of a deeper prefix, which must take the slot over (dropping
        the entry outright would break the other handle's walk at that
        depth and make it unmatchable)."""
        self._handles = [h for h in self._handles if h is not handle]
        self._chains = {}
        for h in self._handles:
            tokens = np.asarray(h.tokens, np.int32)
            for depth, hh in enumerate(self._chain(tokens), start=1):
                self._chains.setdefault((depth, hh), h)

    def match(self, prompt) -> Optional[tuple]:
        """Longest usable cached prefix of ``prompt``.

        Returns ``(handle, reuse_len)`` or None.  ``reuse_len`` is page-
        aligned except when the handle's own trailing partial page matches
        too (then it extends to the handle's full extent), and is always
        ``<= len(prompt) - 1``.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        ps = self.page_size
        best, h = None, 0
        # incremental walk: hash one page at a time and stop at the first
        # miss, so a no-hit lookup costs one page hash, not len(prompt)/ps
        for k in range(len(prompt) // ps):
            h = hash((h, prompt[k * ps:(k + 1) * ps].tobytes()))
            hit = self._chains.get((k + 1, h))
            if hit is None:
                break
            if hit.pinned:                 # released handles never win
                best = hit
        if best is None:
            return None
        # exact verification + partial-tail extension: longest common
        # prefix of the handle's tokens and the prompt
        cached = np.asarray(best.tokens, np.int32)
        n = min(len(cached), len(prompt))
        eq = cached[:n] == prompt[:n]
        matched = n if eq.all() else int(np.argmin(eq))
        reuse = min(matched, best.n_tokens, len(prompt) - 1)
        if reuse < 1:
            return None
        return best, int(reuse)
