"""Paged KV cache: fixed-size pages from one preallocated device pool.

Counterpart of ``ray_tpu/llm/kv_cache.py``.  The K/V history of every
running sequence lives in ONE device buffer per model
([n_layer, num_pages, page_size, n_kv_head, head_dim]), carved into
fixed-size pages.  A sequence maps token positions to pages through its
page table (position p lives in page ``table[p // page_size]`` at slot
``p % page_size``), so sequences grow without reallocation or copying
and admission/retirement only edit page tables and host accounting.

The data path is plain PyTorch, as the JAX package's is plain ``jnp``:
``paged_store`` writes fresh K/V into the pool in place (the JAX engine
donates the pool to its jitted step for the same effect) and
``paged_attend`` gathers a batch's pages and runs masked attention.
The models reach them through ``layer_caches`` (one forward's per-layer
caches, with the pool slots of its positions computed once for every
layer) and ``cached_attention`` (one layer's store and attend).
``PagePool`` is the host-side allocator; it exports its occupancy as
the ``rt_llm_kv_pages_{used,total}`` gauges on every transition, as in
the JAX package.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..ops.matmul import matmul_f32


def init_cache(n_layer: int, num_pages: int, page_size: int,
               n_kv_head: int, head_dim: int, dtype: Any,
               device=None) -> Dict[str, torch.Tensor]:
    """Preallocate the pooled K/V buffers (zeros; pages are recycled
    without clearing: the position mask in ``paged_attend`` makes stale
    contents unreachable)."""
    device = resolve_device(device)
    shape = (n_layer, num_pages, page_size, n_kv_head, head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


def paged_slots(page_table: torch.Tensor, positions: torch.Tensor,
                page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where a forward's new K/V go: ``(rows, flat)``.

    ``rows`` indexes the kept entries (``positions >= 0``) of the
    flattened [B*T] batch and ``flat`` their slots in a layer's pool
    viewed as [num_pages * page_size, h_kv, d] (``page * page_size +
    slot``).  Padding is dropped here, as the JAX scatter's
    ``mode="drop"`` drops it: a padded decode row's page-table row is
    all zeros and page 0 may belong to another sequence, and the padded
    tail of a bucketed prefill would write position 0 a second time in
    the same call.  Selecting the kept rows is one host sync, so the
    models call this once per forward and hand the result to every
    layer."""
    t = positions.shape[1]
    pos = positions.reshape(-1)
    rows = torch.nonzero(pos >= 0).squeeze(1)
    p = pos[rows].long()
    page = page_table[rows // t, p // page_size].long()
    return rows, page * page_size + p % page_size


def paged_store(k_pages, v_pages, k_new, v_new, page_table, positions,
                slots: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Write new K/V ([B, T, h_kv, d]) into one layer's pages
    ([num_pages, page_size, h_kv, d]) in place and return the same
    ``k_pages`` and ``v_pages``.

    ``positions`` is [B, T] absolute token positions; negative entries
    are padding and are not written, so one call serves prefill (T =
    padded prompt length) and batched decode (T = 1, padded rows)
    alike.  ``slots`` is ``paged_slots``' result, when the caller has
    it already."""
    if slots is None:
        slots = paged_slots(page_table, positions, k_pages.shape[1])
    rows, flat = slots
    for pages, new in ((k_pages, k_new), (v_pages, v_new)):
        pool = pages.view(-1, *pages.shape[2:])
        kept = new.reshape(-1, *new.shape[2:])[rows]
        pool.index_copy_(0, flat, kept.to(pages.dtype))
    return k_pages, v_pages


def paged_attend(q, k_pages, v_pages, page_table, positions):
    """Causal attention of q ([B, T, h, d]) against the paged cache.

    Gathers each sequence's pages ([B, P, page, h_kv, d] ->
    [B, P*page, h_kv, d]) and masks by ABSOLUTE position: cache slot j
    is visible to a query at position p iff j <= p, which both enforces
    causality and hides unwritten or stale slots.  Masked scores are
    -1e30, as in JAX, so a padded row that sees no slot gets a uniform,
    finite softmax.  Scores are float32 (``matmul_f32``); GQA caches
    store h_kv heads and repeat them to h here, in ``jnp.repeat``'s
    order."""
    b, t, h, d = q.shape
    table = page_table.long()
    ks, vs = k_pages[table], v_pages[table]      # [B, P, page, h_kv, d]
    n = ks.shape[1] * ks.shape[2]
    ks = ks.reshape(b, n, ks.shape[3], d)
    vs = vs.reshape(b, n, vs.shape[3], d)
    if ks.shape[2] != h:                          # GQA: repeat KV groups
        rep = h // ks.shape[2]
        ks = ks.repeat_interleave(rep, dim=2)
        vs = vs.repeat_interleave(rep, dim=2)
    scores = matmul_f32(q.transpose(1, 2), ks.permute(0, 2, 3, 1))
    scores = scores * (d ** -0.5)                 # [B, h, T, n]
    kv_pos = torch.arange(n, device=q.device)
    mask = kv_pos[None, None, None, :] <= positions[:, None, :, None]
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, vs.transpose(1, 2)).transpose(1, 2)


def layer_caches(kv_cache: Dict[str, torch.Tensor],
                 positions: torch.Tensor) -> List[Dict[str, Any]]:
    """One decode forward's per-layer caches: each layer's views of the
    pool (``kv_cache``: "k_pages", "v_pages" [L, pages, page, h_kv, d]
    and "page_table" [B, P]), the positions, and ``paged_slots``'
    result, computed once for all layers."""
    k, v, table = (kv_cache[n] for n in ("k_pages", "v_pages",
                                         "page_table"))
    slots = paged_slots(table, positions, k.shape[2])
    return [{"k_pages": k[i], "v_pages": v[i], "page_table": table,
             "positions": positions, "slots": slots}
            for i in range(k.shape[0])]


def cached_attention(q, k, v, cache: Dict[str, Any]):
    """One layer's decode-mode attention: write k and v ([B, T, h_kv,
    d]) into its pages, then attend q ([B, T, h, d]) against them.
    ``cache`` is one of ``layer_caches``' entries.  Returns the output
    [B, T, h, d] and the layer's (k_pages, v_pages)."""
    table, positions = cache["page_table"], cache["positions"]
    pages = paged_store(cache["k_pages"], cache["v_pages"], k, v, table,
                        positions, cache.get("slots"))
    return paged_attend(q, *pages, table, positions), pages


def pages_for(n_tokens: int, page_size: int) -> int:
    return max(1, -(-n_tokens // page_size))


class PagePool:
    """Host-side allocator for the device page buffer.

    All-or-nothing allocation (a sequence either gets every page it
    asked for or stays queued: partial grants would deadlock two growing
    sequences against each other), a LIFO free list for locality, and
    occupancy exported as ``rt_llm_kv_pages_used`` /
    ``rt_llm_kv_pages_total`` gauges on every transition.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be > 0")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._lock = threading.Lock()
        # Gauge handles cached once: alloc/free is on the decode path.
        self._gauges = None
        try:
            from ..util.metrics import Gauge

            self._gauges = (
                Gauge("rt_llm_kv_pages_used",
                      "KV-cache pages currently allocated to "
                      "sequences."),
                Gauge("rt_llm_kv_pages_total",
                      "Total KV-cache pages in the device pool."))
        except Exception:
            pass
        self._publish(self.num_pages)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages or None (never a partial grant)."""
        if n <= 0:
            return []
        with self._lock:
            if len(self._free) < n:
                return None
            pages = [self._free.pop() for _ in range(n)]
            free_now = len(self._free)
        self._publish(free_now)
        return pages

    def free(self, pages: List[int]) -> None:
        if not pages:
            return
        with self._lock:
            self._free.extend(pages)
            free_now = len(self._free)
            if free_now > self.num_pages:
                raise AssertionError(
                    f"page pool over-freed: {free_now} free of "
                    f"{self.num_pages}")
        self._publish(free_now)

    @property
    def available(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used(self) -> int:
        return self.num_pages - self.available

    def _publish(self, free_now: int) -> None:
        if self._gauges is None:
            return
        try:
            self._gauges[0].set(float(self.num_pages - free_now))
            self._gauges[1].set(float(self.num_pages))
        except Exception:
            pass
