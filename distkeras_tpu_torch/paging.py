"""Block-paged KV memory for ``serving.DecodeEngine`` and the host-side
page allocator behind its QoS scheduler, the port of
``distkeras_tpu/paging.py``.

KV lives in fixed-size pages (``page_size`` rows), one device pool per
4-D cache leaf, and each slot holds a page table.  A program gathers a
slot's pages into the exact envelope layout (``[slots, KVH, env, D]``),
runs the unchanged envelope body and scatters the result back, so the
tokens equal the envelope engine's: the attention sees the same live
rows bit for bit, and masked rows (stale page data against zeros) add
``exp(-1e30 - max) == 0`` either way while they are finite.

Page 0 is the garbage page: every unallocated table entry points at it,
so the envelope-wide scatter is always well formed (its duplicate
indices all land on page 0, which no live row reads) and the gather
never faults.  ``PageAllocator`` hands out ids ``1..n_pages`` from a
free list with per-tenant quotas.

The pool layout per 4-D cache leaf is ``[n_pages + 1, KVH, page_size,
D]``, the prefix store's segment shape batched over pages, so with
``page_size == prefill_align`` a prefix hit is a copy into a page and a
donation a slice out of one.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

#: the reserved garbage page id (never allocated; the table's filler)
GARBAGE_PAGE = 0

#: dtype names as numpy and ``ml_dtypes`` write them (the KV wire's)
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.float16: "float16", torch.int8: "int8"}


def pages_for(tokens: int, page_size: int) -> int:
    """Pages covering ``tokens`` rows (ceil division)."""
    return -(-int(tokens) // int(page_size))


def build_pool(leaves, n_pages: int, page_size: int) -> list:
    """Zeroed page pool: one ``[n_pages + 1, KVH, page, D]`` tensor per
    ``[S, KVH, L, D]`` cache leaf, in the same order.  Row 0 is the
    garbage page.  Zero-init keeps every pool value finite: the
    masked-row argument needs finite garbage, never NaN."""
    return [torch.zeros((n_pages + 1, x.shape[1], page_size, x.shape[3]),
                        dtype=x.dtype, device=x.device) for x in leaves]


def pool_nbytes(pages: list) -> int:
    return sum(p.numel() * p.element_size() for p in pages)


def leaf_templates(segments) -> list[dict]:
    """``{"shape", "dtype"}`` of one KV block's segment leaves (torch
    tensors or numpy arrays): the wire meta ``serving.pack_kv_blocks``
    sends ahead of the raw bytes, with numpy's dtype names
    (``"bfloat16"`` as ``ml_dtypes`` writes it)."""
    out = []
    for s in segments:
        if isinstance(s, torch.Tensor):
            name = DTYPE_NAMES[s.dtype]
        else:
            name = str(np.asarray(s).dtype)
        out.append({"shape": [int(d) for d in s.shape], "dtype": name})
    return out


def gather_cache(pages: list, table) -> list:
    """The envelope-layout leaves ``[S, KVH, MB * page, D]`` of the
    slots whose ``[S, MB]`` page ``table`` is given (fresh tensors)."""
    s, mb = table.shape
    out = []
    for p in pages:                                    # [P+1, KVH, pg, D]
        x = p[table]                                   # [S, MB, KVH, pg, D]
        out.append(x.transpose(1, 2).reshape(
            s, p.shape[1], mb * p.shape[2], p.shape[3]))
    return out


def scatter_cache(pages: list, leaves: list, table) -> None:
    """Write envelope-layout ``leaves`` back into the pages of ``table``
    in place.  Unallocated entries are all ``GARBAGE_PAGE``, so the
    duplicate indices land on page 0 only (which write wins there is
    irrelevant); a live page appears once."""
    flat = table.reshape(-1)
    s, mb = table.shape
    for p, x in zip(pages, leaves):
        kvh, page, d = p.shape[1:]
        p[flat] = x.reshape(s, kvh, mb, page, d).transpose(1, 2).reshape(
            s * mb, kvh, page, d)


class PageAllocator:
    """Host-side free list over page ids ``1..n_pages`` with per-tenant
    quotas: an int caps every tenant, a mapping the listed ones, ``None``
    none.  Mutated only on the engine's stepping thread; ``n_free`` is a
    plain int read, safe from other threads."""

    def __init__(self, n_pages: int, page_size: int, tenant_quota=None):
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # pop() order 1, 2, ...: deterministic ids for a seeded drill
        self._free = list(range(self.n_pages, 0, -1))
        self.tenant_quota = tenant_quota
        self.used: dict = {}          # tenant -> pages held
        self.allocated_total = 0
        self.freed_total = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    def quota_for(self, tenant) -> Optional[int]:
        if self.tenant_quota is None:
            return None
        if isinstance(self.tenant_quota, Mapping):
            q = self.tenant_quota.get(tenant)
            return None if q is None else int(q)
        return int(self.tenant_quota)

    def fits_quota(self, n: int, tenant) -> bool:
        q = self.quota_for(tenant)
        return q is None or self.used.get(tenant, 0) + n <= q

    def alloc(self, n: int, tenant=None) -> Optional[list]:
        """``n`` page ids, or None when capacity or the tenant's quota is
        short (``fits_quota`` tells which: preemption can fix capacity,
        never quota)."""
        if n > len(self._free) or not self.fits_quota(n, tenant):
            return None
        pids = [self._free.pop() for _ in range(n)]
        self.used[tenant] = self.used.get(tenant, 0) + n
        self.allocated_total += n
        return pids

    def free(self, pids: list, tenant=None) -> None:
        self._free.extend(reversed(pids))
        left = self.used.get(tenant, 0) - len(pids)
        if left > 0:
            self.used[tenant] = left
        else:
            self.used.pop(tenant, None)
        self.freed_total += len(pids)

    def stats(self) -> dict:
        return {"n_pages": self.n_pages, "page_size": self.page_size,
                "free": self.n_free,
                "allocated_total": self.allocated_total,
                "freed_total": self.freed_total,
                "tenants": dict(self.used)}
