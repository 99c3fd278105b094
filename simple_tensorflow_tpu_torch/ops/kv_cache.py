"""KV caches on the device: paged and per slot.

Port of ``simple_tensorflow_tpu/ops/kv_cache_ops.py`` (the
``KVCacheAlloc/Append/Gather/PageCopy`` lowerings, :138-214, and the
``KVCache`` handle, :235-366), in two classes:

- :class:`KVCache`, the paged cache of the causal LM: one tensor
  ``(num_pages + 1, page_len, H, hd)``; the last page is the scratch page
  that bucket-padding rows write into and read from, so a padded row never
  touches a live sequence's pages.
- :class:`SlotKVCache`, the slot cache of the encoder-decoder: rows
  ``(num_slots + 1, max_len, *inner)``, one slot a sequence, the last the
  scratch slot; ``inner`` is ``(H, hd)`` for K/V and ``()`` for the
  source-bias cache.

The JAX package threads the cache through each step as a donated value
(functional ``.at[].set``); here the methods update the tensor IN PLACE,
which is what donation bought there: no second copy of the cache.
"""

from __future__ import annotations

import torch


class KVCache:
    """One paged cache tensor and the three operations on it."""

    def __init__(self, num_pages: int, page_len: int, heads: int,
                 head_dim: int, dtype=torch.float32, device="cpu"):
        # + 1: the scratch page
        self.data = torch.zeros((num_pages + 1, page_len, heads, head_dim),
                                dtype=dtype, device=device)

    def append(self, value, pages, offsets):
        """Write ``value (B, P, H, hd)`` at rows ``offsets[b] + j`` of
        physical page ``pages[b]`` (one page per sequence per call)."""
        p = value.shape[1]
        rows = offsets.to(torch.long)[:, None] + torch.arange(
            p, device=value.device)[None, :]
        self.data[pages.to(torch.long)[:, None], rows] = value.to(
            self.data.dtype)

    def gather(self, page_tables):
        """The logical per-sequence view through ``page_tables (B,
        n_blocks)``: ``(B, n_blocks * page_len, H, hd)``, block b's pages
        concatenated in table order (a contiguous copy)."""
        b, nb = page_tables.shape
        rows = self.data[page_tables.to(torch.long)]
        return rows.reshape((b, nb * self.data.shape[1]) + self.data.shape[2:])

    def copy_page(self, dst: int, src: int):
        """Copy-on-write: duplicate physical page ``src`` into ``dst``."""
        self.data[dst].copy_(self.data[src])


class SlotKVCache:
    """One cache row a slot (``slots (B,)`` index whole rows), the last row
    the scratch slot. Appends whose position reaches ``max_len`` are
    dropped, as the JAX scatter drops out-of-bounds updates (``.at[].set``,
    :183): the storage holds one more position a row, a sink that such
    writes land in and no gather reads, so the drop needs no data-dependent
    shape (a captured step can hold it). :attr:`data` is the
    ``(num_slots + 1, max_len, *inner)`` view without the sink."""

    def __init__(self, num_slots: int, max_len: int, inner=(),
                 dtype=torch.float32, device="cpu"):
        self.max_len = int(max_len)
        self._store = torch.zeros(
            (int(num_slots) + 1, self.max_len + 1) + tuple(inner),
            dtype=dtype, device=device)
        self._rows = torch.arange(self.max_len, device=self._store.device)

    @property
    def data(self):
        return self._store[:, :self.max_len]

    def alloc(self):
        """Zero-fill every row (the engine's start)."""
        self._store.zero_()

    def append(self, value, slots, positions):
        """Write ``value (B, P, *inner)`` at rows ``positions[b] + j`` of
        slot ``slots[b]``; positions at or past ``max_len`` are dropped."""
        p = value.shape[1]
        rows = positions.to(torch.long)[:, None] + torch.arange(
            p, device=value.device)[None, :]
        self._store[slots.to(torch.long)[:, None],
                    rows.clamp(max=self.max_len)] = value.to(
                        self._store.dtype)

    def gather(self, slots):
        """The slots' rows ``(B, max_len, *inner)`` (a contiguous copy)."""
        return self._store[slots.to(torch.long)[:, None], self._rows]
